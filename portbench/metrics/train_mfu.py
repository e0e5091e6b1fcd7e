"""train_mfu: the whole train step's share of the card's float32 peak.

Model FLOP of the traced window's steps (forward and backward, three
forwards; attention on the valid keys: ``portbench/flops.py``) over the
traced window's wall time, which ends in a synchronize, over 67 TFLOP/s.
"""

from portbench import flops
from portbench.roofline import PEAK_F32_FLOPS

LAYER = "the train step: models/bst.py under train/loop.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_ex_s"
KIND = "train"


def read(trace):
    if trace.kind != KIND or not trace.data.get("steps"):
        return None
    work = sum(flops.train_step(trace.cfg, lens) for lens in trace.data["history_lengths"])
    return 100.0 * work / trace.window_s / PEAK_F32_FLOPS
