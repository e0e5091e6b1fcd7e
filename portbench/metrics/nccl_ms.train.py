"""nccl_ms.train: device ms a data-parallel train step spends in NCCL.

Rank 0's device operations whose name holds ``nccl`` (the exchange of the
sharded tables' lookups and their gradients, the gradients' all-reduce,
batch norm's global statistics), summed over the traced window and divided
by its steps.
"""

LAYER = "parallel/multihost.py + embed/sharded.py collectives (NCCL)"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "train_ex_s"
KIND = "train_dp"
NCCL = "nccl"


def read(trace):
    if trace.kind != "train" or not trace.data.get("steps"):
        return None
    ms, count = trace.device_ms(NCCL)
    return ms / trace.data["steps"] if count else None
