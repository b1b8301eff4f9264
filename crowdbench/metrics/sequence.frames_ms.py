"""sequence.frames_ms: mean ms a call inside ``pipeline.people_of_cloud``
(preprocess and people extraction of each frame before the last), from
the synchronised part of a traced run."""


def read(run):
    if not run.scans or "people_of_cloud" not in run.spans:
        return None
    return 1e3 * sum(run.spans["people_of_cloud"]) / run.scans
