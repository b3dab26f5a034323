"""``forward_ms.train``.

Host ms per step inside ``toist.encode`` and ``toist.decode``.
"""
from benchmark import spans


def read(run):
    return spans.span_ms(run, "train", ("toist.encode", "toist.decode"))
