"""flow.ms: mean ms a scan inside ``models.flow.analyze_flow``, from the
synchronised part of a traced run."""


def read(run):
    if not run.scans or "analyze_flow" not in run.spans:
        return None
    return 1e3 * sum(run.spans["analyze_flow"]) / run.scans
