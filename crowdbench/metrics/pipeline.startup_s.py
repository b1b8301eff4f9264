"""pipeline.startup_s: seconds of the program's start-up by its own
spans' aggregates (``utils.profiling.timings``, kept for the whole
process): the top-level ``setup.*`` spans (the package's imports,
``Pipeline.__init__``, the kernels' load where it runs outside any other
span) and the process's first ``pipeline.analyze`` (each shape's first
call, and the kernels' load inside it). A span inside another is counted
once, in the outer one. Nothing where the port keeps no such spans."""


def read(run):
    from lidar_ai_recommendation_software_tpu_torch.utils import profiling

    aggs = profiling.timings()
    if "setup.import" not in aggs or "pipeline.analyze" not in aggs:
        return None
    return (sum(a.get("top_s", 0.0) for n, a in aggs.items()
                if n.startswith("setup."))
            + aggs["pipeline.analyze"]["first_ms"] / 1e3)
