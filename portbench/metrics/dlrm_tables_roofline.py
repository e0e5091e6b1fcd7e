"""dlrm_tables_roofline: DLRM-DCNv2's tables' path's share of its roofline.

The traced steps' needed bytes of the tables (``portbench/flops_dlrm.py``:
each id's row read, the pooled rows written and their gradients read, each
touched row's gradient, parameter and Adagrad accumulator read and written
once, the sparse ideal) over 3.35 TB/s, over the device time of every kernel
and copy but the matrix products (those whose name holds ``gemm``).
"""

from portbench.roofline import PEAK_BYTES

LAYER = "embed/tables.py lookups, their gradient and train/optimizers.py Adagrad"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_ex_s"
KIND = "train_dlrm"
GEMM = "gemm"


def read(trace):
    if trace.kind != "train" or "multi_hot_sizes" not in trace.cfg or not trace.data.get("steps"):
        return None
    other_ms = sum(d for _, _, d in trace.events) / 1e3 - trace.device_ms(GEMM)[0]
    if other_ms <= 0:
        return None
    return 100.0 * (trace.data["table_bytes"] / PEAK_BYTES * 1e3) / other_ms
