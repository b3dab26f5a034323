"""``backward_ms.train``.

Host ms per step inside ``toist.backward``: the backward and the
gradients' cast onto the f32 masters.
"""
from benchmark import spans


def read(run):
    return spans.span_ms(run, "train", ("toist.backward",))
