"""``answer_wait_ms.serve``.

Host ms per call inside ``toist.d2h``: the answer's copy to the host,
which waits for the device; near 0 where the host sets the pace.
"""
from benchmark import spans


def read(run):
    return spans.span_ms(run, "serve", ("toist.d2h",))
