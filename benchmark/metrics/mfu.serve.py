"""``mfu.serve``.

Model FLOP per second of the measured window over the bf16 peak.
"""
from benchmark import readers


def read(run):
    return readers.mfu(run, "serve")
