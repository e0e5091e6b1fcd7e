"""dlrm_train_mfu: DLRM-DCNv2's whole train step's share of the card's
float32 peak.

Model FLOP of the traced window's steps (three forwards of the matrix
products a row: ``portbench/flops_dlrm.py``) over the traced window's wall
time, which ends in a synchronize, over 67 TFLOP/s.
"""

from portbench import flops_dlrm
from portbench.roofline import PEAK_F32_FLOPS

LAYER = "the train step: models/dlrm.py under train/loop.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_ex_s"
KIND = "train_dlrm"


def read(trace):
    if trace.kind != "train" or "multi_hot_sizes" not in trace.cfg or not trace.data.get("steps"):
        return None
    work = flops_dlrm.train_step(trace.cfg, trace.data["examples"])
    return 100.0 * work / trace.window_s / PEAK_F32_FLOPS
