"""``kmeans_useful.distill``.

% of the k-means iterations issued in the steps after set-up that found
the centers still moving (the program's ``kmeans_iters`` over its
``kmeans_issued``, summed by ``distill.run``).
"""


def read(run):
    if run.get("mode") != "train" or not run.get("kmeans_issued"):
        return None
    return 100.0 * run["kmeans_iters"] / run["kmeans_issued"]
