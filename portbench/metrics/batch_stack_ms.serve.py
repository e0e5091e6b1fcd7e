"""batch_stack_ms.serve: host ms a served batch takes to stack.

The program's span ``serve.stack`` under ``serve.flush``: the examples'
columns stacked and padded to the bucket. Mean over the traced window's
batches.
"""

from portbench import spans

LAYER = "serving/server.py BatchingPredictor"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    return spans.per_batch_ms(trace, "serve.stack")
