"""sequence.host_reads: host reads a call counted in the port's records of
``Pipeline.analyze_sequence`` (a ``pipeline.sequence`` scan) outside its
nested ``pipeline.analyze``: the sequence's fit, each earlier frame's
upload, extraction and overflow guards, the tracking and its readback.
The counter ``host_reads`` of a traced run's session (a part of its own):
each call that torch's sync debug mode reports as waiting for the card, a
floor. Nothing where no span of the session counted a host read (no
card), or the port keeps no such records."""


def read(run):
    reads, calls, counted = 0, 0, False
    for scan in run.records:
        if not scan.spans or scan.spans[0].name != "pipeline.sequence":
            continue
        calls += 1
        nested = set()  # the spans under the last frame's analysis
        for i, sp in enumerate(scan.spans):  # parents open first
            counted = counted or "host_reads" in sp.counters
            if sp.name == "pipeline.analyze" or sp.parent in nested:
                nested.add(i)
            else:
                reads += sp.counters.get("host_reads", 0)
    if not run.recorded or not calls or not counted:
        return None
    return reads / run.recorded
