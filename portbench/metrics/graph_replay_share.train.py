"""graph_replay_share.train: the share of train steps that replayed a CUDA graph.

The program's spans ``train.replay`` under ``train.step``
(``Trainer.train_step``, which replays the captured step where it can),
counted over the traced window's ``train.step`` spans. Nothing where the
program records no ``train.replay`` span.
"""

from portbench import spans

LAYER = "train/loop.py Trainer.train_step (the host's launch chain)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_ex_s"
KIND = "train"


def read(trace):
    records = spans.recorded() if trace.kind == KIND else None
    if not records:
        return None
    replays, steps = spans.under(records, "train.step", "train.replay")
    return 100.0 * len(replays) / steps if replays else None
