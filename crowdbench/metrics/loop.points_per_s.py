"""loop.points_per_s: the points of every scan completed in the untraced
part of a traced run (the first half of its first third), over that
part's seconds: ``points_per_s`` as a per-layer reading, for the cells
whose host-bound runs spread too widely to hold it end to end. Nothing
where no scan completed."""


def read(run):
    if not run.plain.get("points") or run.plain.get("window_s", 0) <= 0:
        return None
    return run.plain["points"] / run.plain["window_s"]
