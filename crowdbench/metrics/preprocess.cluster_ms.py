"""preprocess.cluster_ms: mean ms a scan inside
``ops.clustering.dbscan_labels``, from the synchronised part of a traced
run."""


def read(run):
    if not run.scans or "dbscan_labels" not in run.spans:
        return None
    return 1e3 * sum(run.spans["dbscan_labels"]) / run.scans
