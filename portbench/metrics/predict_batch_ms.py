"""predict_batch_ms: host wall ms of one ``Predictor.predict_batch`` call.

A span the benchmark records around each call of the window (numpy in,
device, numpy out; it ends in the copy back, so it is synchronous): total
over calls.
"""

LAYER = "serving/predictor.py Predictor.predict_batch"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    calls = trace.data.get("calls") if trace.kind == KIND else None
    if not calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in calls) / len(calls)
