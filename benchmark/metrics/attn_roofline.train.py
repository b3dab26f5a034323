"""``attn_roofline.train``.

Attention calls' least time over their kernels' device time.
"""
from benchmark import readers


def read(run):
    return readers.attn_roofline(run, "train")
