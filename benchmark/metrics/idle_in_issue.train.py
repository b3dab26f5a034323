"""``idle_in_issue.train``.

% of the device's idle time in which the host was issuing work.
"""
from benchmark import spans


def read(run):
    return spans.idle_in_issue(run, "train")
