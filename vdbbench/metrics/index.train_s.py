"""Seconds of the index's training in set-up: the self seconds of the
IVF k-means, assignment and repack and of the PQ spill centroids, OPQ and
codebook spans."""

from vdbbench.spans import self_seconds

SPANS = ("vdb/ivf.kmeans", "vdb/ivf.assign", "vdb/ivf.repack",
         "vdb/pq.spill_cids", "vdb/pq.opq", "vdb/pq.codebook")


def read(rec):
    return self_seconds(rec, SPANS)
