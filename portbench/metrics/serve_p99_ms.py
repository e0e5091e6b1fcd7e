"""serve_p99_ms: the 99th percentile of request latency in a traced run.

Each request timed from its due time to its last candidate's answer, as
``serve_p50_ms`` is, over the requests due in the window's quiet part: from
a second after collecting the profiler's trace let the process go (it holds
it up to a second) to the window's end.  It is a per-layer reading and not
an end-to-end metric with a bound: on the card's host its untraced runs
spread by 30-40% between quartiles at a 20 s window, more than any
allowed bound holds.  The tail is set by the whole process (the batcher's
queue, batch and resolve, the predictor, and the interpreter's full
collections, which hold every thread), so its layer is the process.
"""

import numpy as np

LAYER = "the whole serving process: batcher, predictor and interpreter"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    lat = trace.data.get("quiet_latency_ms") if trace.kind == KIND else None
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(lat, 99))
