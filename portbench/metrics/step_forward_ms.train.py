"""step_forward_ms.train: host ms a train step spends in ``train.forward``.

The program's span ``train.forward`` under ``train.step``
(``Trainer.train_step``): ``model.train()`` and ``_loss_and_logits`` under the
compaction context. Its spans of the traced window, summed, over the window's
``train.step`` spans. Host time: it ends when the host has issued the phase's
work, or waited for the device where the phase synchronizes.
"""

from portbench import spans

LAYER = "train/loop.py Trainer.train_step (the host's launch chain)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "train_ex_s"
KIND = "train"


def read(trace):
    return spans.per_step_ms(trace, "train.forward")
