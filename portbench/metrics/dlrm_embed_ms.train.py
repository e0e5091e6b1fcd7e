"""dlrm_embed_ms.train: host ms a train step spends in ``dlrm.embed``.

The program's span ``dlrm.embed`` in ``DLRM.forward`` (the DCN form):
the 26 pooled lookups (``FieldEmbedder`` over the tables).  Its spans
of the traced window, summed, over the window's ``train.step`` spans.
Host time: it ends when the host has issued the work, which the device
runs later.
"""

from portbench import spans

LAYER = "models/dlrm.py DLRM.forward (the host's launch chain)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "train_ex_s"
KIND = "train_dlrm"
SPAN = "dlrm.embed"


def read(trace):
    if trace.kind != "train" or "multi_hot_sizes" not in trace.cfg:
        return None
    records = spans.recorded()
    if not records:
        return None
    steps = sum(1 for r in records if r.name == "train.step")
    took = [r.end - r.start for r in records if r.name == SPAN]
    return 1e3 * sum(took) / steps if took and steps else None
