"""pipeline.fit_ms: mean ms a scan inside ``Pipeline.fit_capacity`` (the
host's capacity fit), from the synchronised part of a traced run."""


def read(run):
    if not run.scans or "fit_capacity" not in run.spans:
        return None
    return 1e3 * sum(run.spans["fit_capacity"]) / run.scans
