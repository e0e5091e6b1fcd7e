"""bst_attn_fwd_save_roofline: the BST saving forward kernel's share of its
roofline.

``bst_bound_ms(lengths, H, T, "forward_save")`` on each traced step's batch
(valid keys: the history length plus the target), over the kernel's profiler
time: the mean bound of the traced steps over the mean time of the kernels
caught (one launch a step; a ratio of means, since the trace may lose a
launch at its edges).
"""

from portbench.roofline import bst_bound_ms

LAYER = "ops/cuda/bst_attention.py -> csrc/bst_attention.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_ex_s"
KIND = "train"
KERNEL = "bst_attention_fwd_kernel<true, float>"
BOUND = "forward_save"


def read(trace):
    if trace.kind != KIND or not trace.data.get("steps"):
        return None
    ms, count = trace.device_ms(KERNEL)
    lens = trace.data["history_lengths"]
    if not count:
        return None
    bound = sum(bst_bound_ms(x + 1, trace.data["heads"], trace.data["keys"], BOUND)[0]
                for x in lens)
    return 100.0 * (bound / len(lens)) / (ms / count)
