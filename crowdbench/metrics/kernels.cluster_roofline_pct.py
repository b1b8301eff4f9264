"""kernels.cluster_roofline_pct: the least time the clustering's work could
take on the card, over the device time of every operation launched inside
the ``dbscan_labels`` spans of the profiled part, in percent.

The work is counted from the inputs and outputs alone (``roofline.py``):
each clustered point's xyz read once and its label written once, the
clustered points being the scan's non-ground inliers as the reference
counts them; the bound is the published HBM bandwidth."""

from crowdbench import roofline


def read(run):
    if run.trace is None or run.peaks is None or not run.profiled:
        return None
    work = sum(roofline.clustering_bytes(run.clustered[i])
               for i in run.profiled)
    return roofline.roofline_pct(work, run.trace.span_device_s(
        "dbscan_labels"), run.peaks["hbm_bytes_per_s"])
