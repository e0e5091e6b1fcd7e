"""staged_put_share.train: the share of train steps whose put went to the card
through pinned staging memory in one non-blocking copy.

The program's spans ``put.stage`` (``utils/device.to_device`` on a card:
the batch packed into a pinned buffer of its thread's ring and copied in one
``cudaMemcpyAsync``) under a ``train.put`` span, counted over the traced
window's ``train.step`` spans.  Nothing where the program records no
``put.stage`` span (a put that copies column by column) or has no recorder.
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
    staged, _ = spans.under(records, "train.put", "put.stage")
    steps = sum(1 for r in records if r.name == "train.step")
    return 100.0 * len(staged) / steps if staged and steps else None
