"""density.ms: mean ms a scan inside ``models.density.extract_people`` and
``analyze_density``, from the synchronised part of a traced run."""


def read(run):
    names = ("extract_people", "analyze_density")
    if not run.scans or not all(n in run.spans for n in names):
        return None
    return 1e3 * sum(sum(run.spans[n]) for n in names) / run.scans
