"""``h2d_ms.serve``.

Host ms per call inside ``toist.h2d``: the batch's pins and copies in.
"""
from benchmark import spans


def read(run):
    return spans.span_ms(run, "serve", ("toist.h2d",))
