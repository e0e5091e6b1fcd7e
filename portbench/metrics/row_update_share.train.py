"""row_update_share.train: the share of train steps whose optimizer updated
the tables' touched rows alone.

The program's spans ``train.row_update`` (``optimizers.Adagrad`` applying
the tables' row gradients) under a ``train.optimizer`` span, counted over
the traced window's ``train.step`` spans, in DLRM-DCNv2's cells.  Nothing
where the program records no ``train.row_update`` span (every table updated
densely) or has no recorder.
"""

from portbench import spans

LAYER = "embed/tables.py lookups, their gradient and train/optimizers.py Adagrad"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_ex_s"
KIND = "train_dlrm"


def read(trace):
    if trace.kind != "train" or "multi_hot_sizes" not in trace.cfg:
        return None
    records = spans.recorded()
    if not records:
        return None
    updates, _ = spans.under(records, "train.optimizer", "train.row_update")
    steps = sum(1 for r in records if r.name == "train.step")
    return 100.0 * len(updates) / steps if updates and steps else None
