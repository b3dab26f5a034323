"""``launches.train``.

The host's launch calls per step made inside ``toist.h2d``,
``toist.train_step`` and ``toist.host_read`` (``spans.launches``).
"""
from benchmark import spans


def read(run):
    return spans.launches(run, "train", ("toist.h2d", "toist.train_step",
                                         "toist.host_read"))
