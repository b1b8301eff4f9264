"""pipeline.host_ms: mean ms a scan inside ``Pipeline.analyze`` and
outside its ``analyze_device`` spans (capacity fit, upload, overflow
guards, ``to_host_dict``, the recommendation rules), from the
synchronised part of a traced run."""


def read(run):
    if not run.scans or "analyze" not in run.spans:
        return None
    inside = sum(run.spans.get("analyze_device", ()))
    return 1e3 * (sum(run.spans["analyze"]) - inside) / run.scans
