"""queue_wait_ms.serve: median ms an example waits in the batcher's queue.

The program's span ``serve.queue``, one an example, from its enqueue
(``BatchingPredictor.predict_async``) to the start of the ``serve.flush`` that
takes it: the median over the traced window's examples.
"""

from portbench import spans

LAYER = "serving/server.py BatchingPredictor"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    return spans.median_ms(trace, "serve.queue")
