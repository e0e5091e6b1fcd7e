"""device_idle.train: the share of the traced window with no device work.

1 - busy / window, busy the union of the kernels' and copies' intervals.
"""

LAYER = "the device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_ex_s"
KIND = "train"


def read(trace):
    if trace.kind != KIND:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
