"""density.people_ms: mean ms a scan inside ``models.density.extract_people``
(the clustered buffer's centroids turned into people), from the
synchronised part of a traced run. Nothing unless the port's records of
the run show the ``place_dense`` centroid route (``density.centroids``
spans whose ``route`` is ``"place_dense"``): a scan moved off that route
reads as a missing reading, not as a gain."""

from crowdbench import people_roofline


def read(run):
    if (not run.scans or "extract_people" not in run.spans
            or not people_roofline.takes_place_dense(run.records)):
        return None
    return 1e3 * sum(run.spans["extract_people"]) / run.scans
