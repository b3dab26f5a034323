"""``bank_launches.distill``.

The host's launch calls per step made inside ``toist.bank``
(``spans.launches``): the sequential k-means issue.
"""
from benchmark import spans


def read(run):
    return spans.launches(run, "train", ("toist.bank",))
