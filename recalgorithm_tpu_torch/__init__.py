"""recalgorithm_tpu_torch: the PyTorch / CUDA port of recalgorithm_tpu.

Mirrors the JAX package's module paths (``features/schema.py`` <->
``features/schema.py``, ...).  Plain tensor code is PyTorch; each Pallas TPU
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``, built
by ``ops/cuda/_build.py``; the TFRecord reader and writer are host C++ under
``runtime/cc/``, built by ``runtime/loader.py``.  Imports torch and numpy,
never jax, flax or the JAX package.
"""
