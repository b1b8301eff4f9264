"""kernels.people_roofline_pct: the least time turning the clustered buffer
into people could take on the card, over the device time of every
operation launched inside the ``extract_people`` spans of the profiled
part, in percent.

The work is counted from the layer's inputs alone
(``people_roofline.py``): each clustered point's xyz and cluster id read
once, the clustered points being the scan's non-ground inliers as the
reference counts them; the people's writes are left out, so the share is
a floor. The bound is the published HBM bandwidth. Nothing unless the
port's records of the run show the ``place_dense`` centroid route."""

from crowdbench import people_roofline, roofline


def read(run):
    if (run.trace is None or run.peaks is None or not run.profiled
            or not people_roofline.takes_place_dense(run.records)):
        return None
    work = sum(people_roofline.people_bytes(run.clustered[i])
               for i in run.profiled)
    return roofline.roofline_pct(work, run.trace.span_device_s(
        "extract_people"), run.peaks["hbm_bytes_per_s"])
