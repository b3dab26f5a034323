"""``criterion_ms.train``.

Host ms per step inside ``toist.criterion``: matching costs, the LSA's
launch, the losses.
"""
from benchmark import spans


def read(run):
    return spans.span_ms(run, "train", ("toist.criterion",))
