"""``launches.serve``.

The host's launch calls per call made inside ``toist.predict``
(``spans.launches``).
"""
from benchmark import spans


def read(run):
    return spans.launches(run, "serve", ("toist.predict",))
