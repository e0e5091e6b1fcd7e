"""din_attn_roofline: the DIN attention kernel's share of its roofline.

``din_attention_bound_ms`` on the real rows of each batch served in the
traced window (bucket padding is waste, not need), over the kernel's
profiler time: the mean bound of the calls made while the profiler ran over
the mean time of the kernels it caught (a ratio of means, since the trace
may lose a launch at its edges).
"""


from portbench.roofline import din_attention_bound_ms

LAYER = "ops/cuda/din_attention.py -> csrc/din_attention.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_p50_ms"
KIND = "serve"
KERNEL = "din_attention_kernel"


def read(trace):
    if trace.kind != KIND:
        return None
    ms, count = trace.device_ms(KERNEL)
    traced = trace.data["calls"][:trace.data["traced_calls"]]
    if not count or not traced:
        return None
    t = trace.cfg["schema"]["history"]["max_length"]
    soft = trace.cfg["config"]["use_softmax"]
    bound = sum(din_attention_bound_ms(lens, t, soft)[0] for _, _, lens in traced)
    return 100.0 * (bound / len(traced)) / (ms / count)
