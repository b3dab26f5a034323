"""``idle_share.train``.

Share of the profiled window in which the device runs nothing.
"""
from benchmark import readers


def read(run):
    return readers.idle_share(run, "train")
