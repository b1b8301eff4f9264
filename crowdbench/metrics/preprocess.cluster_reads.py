"""preprocess.cluster_reads: host reads a scan inside the port's own
``preprocess.cluster`` spans (the clustering), its counter ``host_reads``
from the records of its tracing session in a traced run (a part of its
own): each call that torch's sync debug mode reports as waiting for the
card, a floor. Nothing where no span of the session counted a host read
(no card), or the port keeps no such records."""


def read(run):
    spans = [sp for scan in run.records for sp in scan.spans]
    cluster = [sp for sp in spans if sp.name == "preprocess.cluster"]
    if (not run.recorded or not cluster
            or not any("host_reads" in sp.counters for sp in spans)):
        return None
    reads = sum(sp.counters.get("host_reads", 0) for sp in cluster)
    return reads / run.recorded
