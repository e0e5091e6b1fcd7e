"""serve_mfu: the served batch's share of the card's float32 peak.

Model FLOP of the real rows of every ``predict_batch`` call of the window
(``portbench/flops.py``; bucket padding is waste, not need) over the calls'
summed host wall time, over 67 TFLOP/s.
"""

import numpy as np

from portbench import flops
from portbench.roofline import PEAK_F32_FLOPS

LAYER = "serving/predictor.py Predictor.predict_batch"
UNIT = "%"
SOURCE = "program_span"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    calls = trace.data.get("calls") if trace.kind == KIND else None
    if not calls:
        return None
    work = flops.forward(trace.cfg, np.concatenate([lens for _, _, lens in calls]))
    return 100.0 * work / sum(t1 - t0 for t0, t1, _ in calls) / PEAK_F32_FLOPS
