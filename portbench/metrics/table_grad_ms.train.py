"""table_grad_ms.train: device ms a step in the embedding tables' gradient.

The kernels of the lookups' backward (sort, segment sums, scatter), by the
name patterns ``chip_smoke.py`` gave them, summed over the traced window
and divided by its steps.
"""

LAYER = "embed/tables.py + ops/compact_scatter.py (the tables' gradient)"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "train_ex_s"
KIND = "train"
TABLE_GRAD_KERNELS = ("embedding", "segment", "grad_weight", "sum_and_scatter", "adix")


def read(trace):
    if trace.kind != KIND or not trace.data.get("steps"):
        return None
    ms, count = trace.device_ms(*TABLE_GRAD_KERNELS)
    return ms / trace.data["steps"] if count else None
