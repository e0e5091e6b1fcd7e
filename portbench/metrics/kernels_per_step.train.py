"""kernels_per_step.train: device kernels and copies a train step launches.

Every device operation of the traced window over the steps in it: the
length of the launch chain the host issues for one ``Trainer.train_step``.
"""

LAYER = "train/loop.py Trainer.train_step (the host's launch chain)"
UNIT = "ops/step"
SOURCE = "device_trace"
MOVES = "train_ex_s"
KIND = "train"


def read(trace):
    if trace.kind != KIND or not trace.data.get("steps"):
        return None
    return len(trace.events) / trace.data["steps"]
