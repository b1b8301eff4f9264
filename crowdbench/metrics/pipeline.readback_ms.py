"""pipeline.readback_ms: mean ms a scan inside the port's own
``pipeline.readback`` spans (the density and flow results copied to the
host and shifted back by the recentring offset), read from the records of
its tracing session in a traced run: a part of its own, synchronised as
the spans' part is. Nothing where the port keeps no such records."""


def read(run):
    spans = [sp for scan in run.records for sp in scan.spans
             if sp.name == "pipeline.readback"]
    if not run.recorded or not spans:
        return None
    return 1e3 * sum(sp.seconds for sp in spans) / run.recorded
