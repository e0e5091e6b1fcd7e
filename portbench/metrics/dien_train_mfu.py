"""dien_train_mfu: DIEN's whole train step's share of the card's float32
peak.

Model FLOP of the traced window's steps (three forwards of the two
recurrences' input and recurrent products, the attention, the auxiliary
loss's projections and the tower: ``portbench/flops_dien.py``) over the
traced window's wall time, which ends in a synchronize, over 67 TFLOP/s.
"""

from portbench import flops_dien
from portbench.roofline import PEAK_F32_FLOPS

LAYER = "the train step: models/dien.py under train/loop.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_ex_s"
KIND = "train_dien"


def read(trace):
    if trace.kind != "train" or trace.cfg.get("model") != "DIEN" or not trace.data.get("steps"):
        return None
    work = flops_dien.train_step(trace.cfg, trace.data["examples"])
    return 100.0 * work / trace.window_s / PEAK_F32_FLOPS
