"""dlrm_gemm_roofline: DLRM-DCNv2's matrix products' share of their
roofline.

The traced steps' matrix-product FLOP (``portbench/flops_dlrm.py``: the
dense arch, the cross stack and the over arch, three forwards) over
67 TFLOP/s, the float32 peak outside the tensor cores, over the device time
of the kernels whose name holds ``gemm`` (cuBLAS's).  Bound by operations:
at these widths every product's FLOP over the peak exceeds its bytes over
the bandwidth.
"""

from portbench import flops_dlrm
from portbench.roofline import PEAK_F32_FLOPS

LAYER = "ops/mlp.py and ops/interactions.py matrix products (cuBLAS)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_ex_s"
KIND = "train_dlrm"
GEMM = "gemm"


def read(trace):
    if trace.kind != "train" or "multi_hot_sizes" not in trace.cfg or not trace.data.get("steps"):
        return None
    ms, count = trace.device_ms(GEMM)
    if not count:
        return None
    bound_ms = flops_dlrm.train_step(trace.cfg, trace.data["examples"]) / PEAK_F32_FLOPS * 1e3
    return 100.0 * bound_ms / ms
