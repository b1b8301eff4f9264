"""temporal.nodes_ms: mean ms a call inside the port's own
``temporal.nodes`` spans (every kept velocity onto the lattice nodes
within a grid step, chunk by chunk, and the field's statistics), read
from the records of its tracing session in a traced run: a part of its
own, in which the benchmark's synchronised span around
``accumulate_samples`` holds the record until the accumulation's device
work is done. Nothing where the port keeps no such records."""


def read(run):
    spans = [sp for scan in run.records for sp in scan.spans
             if sp.name == "temporal.nodes"]
    if not run.recorded or not spans:
        return None
    return 1e3 * sum(sp.seconds for sp in spans) / run.recorded
