"""serve_rows_per_batch: candidates a served batch holds.

The batcher's own counters over the window: the change of ``requests``
(examples answered) over the change of ``batches``.
"""

LAYER = "serving/server.py BatchingPredictor"
UNIT = "rows"
SOURCE = "program_counter"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    if trace.kind != KIND or not trace.data.get("batches"):
        return None
    return trace.data["requests"] / trace.data["batches"]
