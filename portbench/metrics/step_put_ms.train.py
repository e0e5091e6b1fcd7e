"""step_put_ms.train: host ms a train step spends in ``train.put``.

The program's span ``train.put`` under ``train.step``
(``Trainer.train_step``): ``batch_fits_compact`` and ``_put_batch`` (the host
batch's columns to the device). Its spans of the traced window, summed, over
the window's ``train.step`` spans. Host time: it ends when the host has issued
the phase's work, or waited for the device where the phase synchronizes.
"""

from portbench import spans

LAYER = "train/loop.py Trainer.train_step (the host's launch chain)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "train_ex_s"
KIND = "train"


def read(trace):
    return spans.per_step_ms(trace, "train.put")
