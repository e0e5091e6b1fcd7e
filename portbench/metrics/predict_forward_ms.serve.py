"""predict_forward_ms.serve: host ms of a served batch's forward, to its answers on the host.

The program's span ``predict.forward`` in ``Predictor.predict_batch``, under
``serve.flush``: the forward, the sigmoid and the copy back, which waits for
the device. Mean over the traced window's batches.
"""

from portbench import spans

LAYER = "serving/predictor.py Predictor.predict_batch"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    return spans.per_batch_ms(trace, "predict.forward")
