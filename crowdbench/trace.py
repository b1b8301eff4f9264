"""Spans around the calls into each layer of the port, recorded from the
benchmark's own files, and the reading of ``torch.profiler``'s trace.

``instrument`` wraps, for the length of a ``with`` block, the calls that
``Pipeline.analyze`` makes into its layers (it edits none of them):

  fit_capacity    ``Pipeline.fit_capacity``         pipeline host
  from_numpy      ``PointCloud.from_numpy``         pipeline host (upload)
  analyze_device  ``Pipeline.analyze_device``       the device program
  preprocess      ``preprocess.preprocess``         preprocess
  dbscan_labels   ``ops.clustering.dbscan_labels``  preprocess (clustering)
  extract_people  ``models.density.extract_people`` density
  analyze_density ``models.density.analyze_density`` density
  analyze_flow    ``models.flow.analyze_flow``      flow

with the entry points the cell's kind names in its ``SPANS``, and the
benchmark's loop adds ``analyze`` around each call. Each span is a
``record_function`` range named ``bench.<name>``; with ``sync`` its
host-clock seconds are kept and the device is synchronised at both of its
ends, so a span holds its own device work and no other's. With
``record``, the block also runs in a session of the port's own tracer
(``utils.profiling.tracing``), whose span records and counters the block
yields; a port without that tracer yields none.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Seconds of each span, in the order they ended."""

    def __init__(self, sync: bool):
        self.sync = sync and torch.cuda.is_available()
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    def _sync(self):
        if self.sync:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
            self._sync()
        self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


@contextlib.contextmanager
def instrument(pipe, spans: Spans,
               extra: Sequence[Tuple[str, str, str]] = (),
               record: bool = False):
    """Wrap the layers' entry points of ``pipe`` in ``spans`` (module and
    instance attributes, restored on exit), and each (module, attribute,
    span name) of ``extra``. Yields the records (``Recorder.scans``) of
    the port's tracing session that the block runs in with ``record``,
    else None."""
    from lidar_ai_recommendation_software_tpu_torch import pipeline
    from lidar_ai_recommendation_software_tpu_torch import types as ptypes
    from lidar_ai_recommendation_software_tpu_torch.models import (
        density, flow)
    from lidar_ai_recommendation_software_tpu_torch.ops import clustering
    from lidar_ai_recommendation_software_tpu_torch.utils import profiling

    patches = [(pipeline, "preprocess", "preprocess"),
               (clustering, "dbscan_labels", "dbscan_labels"),
               (density, "extract_people", "extract_people"),
               (density, "analyze_density", "analyze_density"),
               (flow, "analyze_flow", "analyze_flow")]
    patches += [(importlib.import_module(mod), attr, name)
                for mod, attr, name in extra]
    saved = [(mod, attr, name, getattr(mod, attr))
             for mod, attr, name in patches]
    from_numpy = ptypes.PointCloud.__dict__["from_numpy"]
    tracing = getattr(profiling, "tracing", None) if record else None
    try:
        for mod, attr, name, fn in saved:
            setattr(mod, attr, spans.wrap(name, fn))
        ptypes.PointCloud.from_numpy = staticmethod(
            spans.wrap("from_numpy", ptypes.PointCloud.from_numpy))
        pipe.fit_capacity = spans.wrap("fit_capacity", pipe.fit_capacity)
        pipe.analyze_device = spans.wrap("analyze_device",
                                         pipe.analyze_device)
        with (tracing() if tracing else contextlib.nullcontext()) as rec:
            yield None if rec is None else rec.scans
    finally:
        for mod, attr, _, fn in reversed(saved):
            setattr(mod, attr, fn)
        ptypes.PointCloud.from_numpy = from_numpy
        del pipe.fit_capacity, pipe.analyze_device


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def device_profile(path, on_card: bool):
    """``torch.profiler``'s Kineto trace of the block, written to ``path``
    as a chrome trace: every kernel, copy and set on the card, each launch
    with its correlation, and the ``bench.*`` ranges. The host records
    those ranges alone (``RecordScope.USER_SCOPE``), not each operator:
    on an H100's host the operators' records cost about 6 ms of a
    40,960-point frame, idle device time that the unprofiled program does
    not have. The device trace itself (CUPTI, every launch) still costs
    the host 10-15 ms of such a frame; ``run.py`` prints each part's mean
    scan."""
    from torch._C._autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
    from torch._C._profiler import RecordScope

    # the public profiler builds this torch's config and activity set
    prof = torch.autograd.profiler.profile(
        use_device="cuda" if on_card else None, use_kineto=True)
    config, acts = prof.config(), prof.kineto_activities
    if on_card and torch.profiler.ProfilerActivity.CUDA not in acts:
        raise RuntimeError("torch.profiler cannot trace the card here")
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    try:
        yield
    finally:
        if on_card:
            torch.cuda.synchronize()
        _disable_profiler().save(str(path))


def short_name(name: str, keep: int = 160) -> str:
    """A kernel's name without ``void`` and cut to ``keep`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name[:keep]


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merge(intervals))


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """What the metrics read from a chrome trace of ``torch.profiler``:
    times in seconds on the trace's clock.

    ``device``  (start, end, name) of every kernel, copy and set;
    ``spans``   (start, end, name) of every ``bench.*`` range on the host;
    ``launched`` name -> the device operations launched inside that span;
    ``window``  (start, end): from the first ``analyze`` span's start to
                the last one's end."""

    def __init__(self, events: List[Dict]):
        self.device = []
        self.spans = []
        launches = []
        by_corr: Dict[int, List[int]] = defaultdict(list)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev.get("dur", 0.0)) * 1e-6
            if cat in DEVICE_CATS:
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    by_corr[corr].append(len(self.device))
                self.device.append((s, e, short_name(ev["name"])))
            elif (cat == "user_annotation"
                  and ev["name"].startswith(PREFIX)):
                self.spans.append((s, e, ev["name"][len(PREFIX):]))
            elif cat in LAUNCH_CATS:
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launches.append((s, corr))
        analyze = [sp for sp in self.spans if sp[2] == "analyze"]
        self.window = ((min(s for s, _, _ in analyze),
                        max(e for _, e, _ in analyze)) if analyze
                       else (0.0, 0.0))
        self.launched: Dict[str, List[int]] = defaultdict(list)
        launches.sort()
        starts = [t for t, _ in launches]
        for s, e, name in self.spans:
            lo = bisect.bisect_left(starts, s)
            hi = bisect.bisect_right(starts, e)
            for _, corr in launches[lo:hi]:
                self.launched[name].extend(by_corr.get(corr, ()))

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as fh:
            data = json.load(fh)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran: the
        union of their intervals, clipped to the window."""
        w0, w1 = self.window
        return union_length([(max(s, w0), min(e, w1))
                             for s, e, _ in self.device if e > w0 and s < w1])

    def span_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside ``name``."""
        return sum(self.device[i][1] - self.device[i][0]
                   for i in set(self.launched.get(name, ())))

    def top_device_ops(self, k: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        w0, w1 = self.window
        for s, e, name in self.device:
            if s >= w0 and e <= w1:
                total[name] += e - s
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle device seconds of the window by the innermost span the
        host was in at each gap's midpoint (``loop`` outside every span),
        largest first."""
        w0, w1 = self.window
        busy = merge([(max(s, w0), min(e, w1))
                      for s, e, _ in self.device if e > w0 and s < w1])
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        total: Dict[str, float] = defaultdict(float)
        for (a, b), name in zip(gaps, self.host_spans_at(
                [(a + b) / 2 for a, b in gaps])):
            total[name] += b - a
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda x: -x[1])[:k]]

    def host_spans_at(self, times: List[float]) -> List[str]:
        """The innermost span open at each of the ascending ``times``
        (``loop`` where none is): one sweep, spans being nested."""
        spans = sorted(self.spans, key=lambda sp: (sp[0], -sp[1]))
        out, stack, nxt = [], [], 0
        for t in times:
            while nxt < len(spans) and spans[nxt][0] <= t:
                while stack and stack[-1][1] < spans[nxt][0]:
                    stack.pop()
                stack.append(spans[nxt])
                nxt += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else "loop")
        return out
