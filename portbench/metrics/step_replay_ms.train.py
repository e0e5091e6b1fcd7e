"""step_replay_ms.train: host ms a train step spends in ``train.replay``.

The program's span ``train.replay`` under ``train.step``
(``Trainer.train_step``): the rate written and the captured step's graph
launched. Its spans of the traced window, summed, over the window's
``train.step`` spans. Host time: it ends when the host has issued the
replay, not when the device has run it.
"""

from portbench import spans

LAYER = "train/loop.py Trainer.train_step (the host's launch chain)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "train_ex_s"
KIND = "train"


def read(trace):
    return spans.per_step_ms(trace, "train.replay")
