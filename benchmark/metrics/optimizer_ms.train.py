"""``optimizer_ms.train``.

Host ms per step inside ``toist.optimizer``: the reduce, the clip,
AdamW, the copy back, the EMA.
"""
from benchmark import spans


def read(run):
    return spans.span_ms(run, "train", ("toist.optimizer",))
