"""CLI alias: `python -m recalgorithm_tpu_torch.cli.deepfm` trains DeepFM
(``cli.main`` with ``--model DeepFM`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="DeepFM")
