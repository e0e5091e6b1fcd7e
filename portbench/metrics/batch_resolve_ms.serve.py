"""batch_resolve_ms.serve: host ms a served batch takes to answer its futures.

The program's span ``serve.resolve`` under ``serve.flush``: one result dict an
example and its ``set_result``, whose done-callbacks run here. Mean over the
traced window's batches.
"""

from portbench import spans

LAYER = "serving/server.py BatchingPredictor"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    return spans.per_batch_ms(trace, "serve.resolve")
