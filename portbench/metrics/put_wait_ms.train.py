"""put_wait_ms.train: host ms a train step's put spends waiting for the card.

The program's spans ``put.wait`` (``utils/device.to_device`` on a card: the
wait on the event of the last copy from the staging slot it is about to
fill, at once unless the host is two puts ahead of the card) inside a
``put.stage`` under a ``train.put`` span, summed over the traced window and
divided by its ``train.step`` spans.  The part of ``step_put_ms.train`` that
is the card's time, not the host's.  Nothing where the program records no
``put.wait`` span or has no recorder.
"""

from portbench import spans

LAYER = "train/loop.py Trainer.train_step (the host's launch chain)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "train_ex_s"
KIND = "train"


def read(trace):
    records = spans.recorded() if trace.kind == KIND else None
    if not records:
        return None
    puts = {r.id for r in records if r.name == "train.put"}
    stages = {r.id for r in records if r.name == "put.stage" and r.parent in puts}
    waits = [r.end - r.start for r in records if r.name == "put.wait" and r.parent in stages]
    steps = sum(1 for r in records if r.name == "train.step")
    return 1e3 * sum(waits) / steps if waits and steps else None
