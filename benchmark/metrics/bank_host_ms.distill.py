"""``bank_host_ms.distill``.

Host ms per step inside ``toist.bank``: the teacher's push, both bank
calls' k-means solves and choices, the snaps.
"""
from benchmark import spans


def read(run):
    return spans.span_ms(run, "train", ("toist.bank",))
