"""``issue_ms.serve``.

Host ms per call inside ``toist.encode``, ``toist.decode`` and
``toist.postprocess``: the host's issue of the forward.
"""
from benchmark import spans


def read(run):
    return spans.span_ms(run, "serve", ("toist.encode", "toist.decode",
                                         "toist.postprocess"))
