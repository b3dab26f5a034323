"""``attn_roofline.serve``.

Attention calls' least time over their kernels' device time.
"""
from benchmark import readers


def read(run):
    return readers.attn_roofline(run, "serve")
