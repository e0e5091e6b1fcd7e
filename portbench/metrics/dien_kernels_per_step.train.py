"""dien_kernels_per_step.train: device kernels and copies a DIEN train step
runs.

Every device operation of the traced window over the steps in it: the
length of the launch chain of one replayed ``Trainer.train_step`` (the
put's copy and the graph's kernels), most of it the two recurrences' 50
steps forward and back.  A fused recurrence would shorten it.
"""

LAYER = "train/loop.py Trainer.train_step (the host's launch chain)"
UNIT = "ops/step"
SOURCE = "device_trace"
MOVES = "train_ex_s"
KIND = "train_dien"


def read(trace):
    if trace.kind != "train" or trace.cfg.get("model") != "DIEN" or not trace.data.get("steps"):
        return None
    return len(trace.events) / trace.data["steps"]
