"""temporal.ms: mean ms a call inside ``models.temporal.temporal_flow_multi``
(the tracking of every pair of frames, the consistency filter, the node
accumulation and the bottlenecks), from the synchronised part of a traced
run."""


def read(run):
    if not run.scans or "temporal_flow" not in run.spans:
        return None
    return 1e3 * sum(run.spans["temporal_flow"]) / run.scans
