"""predict_put_ms.serve: host ms a served batch takes to reach the device.

The program's span ``predict.put`` in ``Predictor.predict_batch``, under
``serve.flush``: each column copied on the host and sent to the device. Mean
over the traced window's batches.
"""

from portbench import spans

LAYER = "serving/predictor.py Predictor.predict_batch"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p50_ms"
KIND = "serve"


def read(trace):
    return spans.per_batch_ms(trace, "predict.put")
