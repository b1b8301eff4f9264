"""temporal.match_ms: mean ms a call inside the port's own
``temporal.match`` spans (every pair's mutual-nearest matching over the
people capacity, and its velocities), read from the records of its
tracing session in a traced run: a part of its own, in which the
benchmark's synchronised span around each ``match_people`` call holds the
record until the matching's device work is done. Nothing where the port
keeps no such records."""


def read(run):
    spans = [sp for scan in run.records for sp in scan.spans
             if sp.name == "temporal.match"]
    if not run.recorded or not spans:
        return None
    return 1e3 * sum(sp.seconds for sp in spans) / run.recorded
