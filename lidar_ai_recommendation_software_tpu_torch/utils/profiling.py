"""Tracing / timing / observability.

The reference has no profiling at all (SURVEY.md §5 — only st.spinner
UX wrappers). This module provides:

  - ``stage``: the one span primitive, a context manager (or decorator)
    that times a stage of the program into a bounded per-name aggregate
    (``timings``, ``report``) and, while a ``torch.profiler`` runs, opens
    a ``record_function`` range ``lidar.<name>``, so the program's spans
    share the device trace's clock;
  - ``tracing``: a session that also keeps each span as a record, grouped
    by scan (every span under one top-level span, such as one
    ``Pipeline.analyze`` call), with its attributes and counters
    (``count``), the host reads torch reports among them;
  - ``device_timer``: steady-state seconds per call of a function on the
    card (CUDA events) or the CPU (host clock), with distinct inputs per
    call;
  - roofline accounting against the card's published peaks.

Outside a session a span costs two clock reads and an aggregate update,
and a counter one check of a module-level flag.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import threading
import time
import warnings
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

PREFIX = "lidar."  # the ``record_function`` ranges' names
MAX_SCANS = 10_000  # a session keeps the records of the last this many
# what torch's sync debug mode warns at each call that waits for the card
SYNC_WARNING = "called a synchronizing CUDA operation"


class _Aggregate:
    """One span name's calls: count, total, last, first and top-level
    seconds (those of calls with no span open around them)."""

    __slots__ = ("count", "total_s", "last_s", "first_s", "top_s")

    def __init__(self, seconds: float):
        self.count = 0
        self.total_s = self.top_s = 0.0
        self.first_s = self.last_s = seconds


_AGGREGATES: Dict[str, _Aggregate] = {}
_AGGREGATES_LOCK = threading.Lock()


def _aggregate(name: str, seconds: float, top: bool) -> None:
    with _AGGREGATES_LOCK:
        agg = _AGGREGATES.get(name)
        if agg is None:
            agg = _AGGREGATES[name] = _Aggregate(seconds)
        agg.count += 1
        agg.total_s += seconds
        agg.last_s = seconds
        if top:
            agg.top_s += seconds


@dataclasses.dataclass
class SpanRecord:
    """One span of a session: ``parent`` is the index of the enclosing
    span in its scan's ``spans`` (None for the scan's root); times are
    ``time.perf_counter_ns``; ``end_ns`` is 0 while the span is open."""

    name: str
    scan: int
    parent: Optional[int]
    start_ns: int
    attrs: Dict
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    end_ns: int = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Scan:
    """The spans under one top-level span, in the order they opened."""

    id: int
    spans: List[SpanRecord] = dataclasses.field(default_factory=list)

    def counters(self) -> Dict[str, int]:
        """Every counter of the scan, summed over its spans."""
        out: Dict[str, int] = collections.Counter()
        for sp in self.spans:
            out.update(sp.counters)
        return dict(out)


class Recorder:
    """A session's records: ``scans``, a ring of the last ``MAX_SCANS``
    scans, and ``dropped``, the scans that fell out of it."""

    def __init__(self):
        self.scans: Deque[Scan] = collections.deque(maxlen=MAX_SCANS)
        self.dropped = 0
        self._ids = itertools.count()
        self._lock = threading.Lock()

    def _open(self, span: "_Stage", parent: Optional["_Stage"]) -> None:
        if parent is None or parent.record is None:
            with self._lock:
                scan = Scan(next(self._ids))
                if len(self.scans) == self.scans.maxlen:
                    self.dropped += 1
                self.scans.append(scan)
            up = None
        else:
            scan, up = parent.scan, parent.index
        span.scan, span.index = scan, len(scan.spans)
        span.record = SpanRecord(span.name, scan.id, up, 0, span.attrs)
        scan.spans.append(span.record)


_SESSION: Optional[Recorder] = None  # the open session, if any


class _Thread(threading.local):
    def __init__(self):
        self.stack: List[_Stage] = []  # this thread's open spans


_THREAD = _Thread()


class _Stage:
    __slots__ = ("name", "attrs", "record", "scan", "index", "_t0", "_top",
                 "_range")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Dict:
        stack = _THREAD.stack
        self._top = not stack
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self.record = None
        if _SESSION is not None:
            _SESSION._open(self, stack[-1] if stack else None)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        if self.record is not None:
            self.record.start_ns = self._t0
        return self.attrs

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _THREAD.stack.pop()
        if self.record is not None:
            self.record.end_ns = t1
        if self._range is not None:
            self._range.__exit__(*exc)
        _aggregate(self.name, (t1 - self._t0) * 1e-9, self._top)
        return False

    def __call__(self, fn: Callable) -> Callable:
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def staged(*args, **kwargs):
            with _Stage(name, dict(attrs)):
                return fn(*args, **kwargs)
        return staged


def stage(name: str, **attrs) -> _Stage:
    """A span named ``name``: ``with stage(name, **attrs) as attrs:``
    around a block (the yielded dict takes attributes known only inside
    it), or ``@stage(name)`` on a function. Nests; the spans open on a
    thread are that thread's own."""
    return _Stage(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span, in a
    session; nothing outside one."""
    if _SESSION is None:
        return
    stack = _THREAD.stack
    if stack and stack[-1].record is not None:
        counters = stack[-1].record.counters
        counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def tracing() -> Iterator[Recorder]:
    """A session: every span opened inside it is kept as a record in the
    yielded ``Recorder``, and each call that torch reports as waiting for
    the card (its sync debug mode, switched to "warn" for the session and
    restored after) adds one to the counter ``host_reads`` of the
    innermost open span; those warnings go no further. Torch's mode does
    not detect every synchronising call, so the count is a floor. One
    session at a time in a process."""
    global _SESSION
    if _SESSION is not None:
        raise RuntimeError("a tracing session is already open")
    on_card = torch.cuda.is_available()
    with warnings.catch_warnings():
        shown = warnings.showwarning

        def host_read(message, category, *args, **kwargs):
            if str(message).startswith(SYNC_WARNING):
                count("host_reads")
            else:
                shown(message, category, *args, **kwargs)

        warnings.filterwarnings("always", message=SYNC_WARNING)
        # torch's notice, on switching the mode, that it is a prototype
        warnings.filterwarnings("ignore", message="Synchronization debug")
        warnings.showwarning = host_read
        mode = torch.cuda.get_sync_debug_mode() if on_card else 0
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        _SESSION = Recorder()
        try:
            yield _SESSION
        finally:
            _SESSION = None
            if on_card:
                torch.cuda.set_sync_debug_mode(mode)


def timings() -> Dict[str, Dict[str, float]]:
    """Each span name's calls: count, total seconds, mean, last and first
    ms, and the seconds of the calls with no span open around them."""
    with _AGGREGATES_LOCK:
        return {name: {"count": a.count, "total_s": a.total_s,
                       "mean_ms": a.total_s / a.count * 1000,
                       "last_ms": a.last_s * 1000,
                       "first_ms": a.first_s * 1000, "top_s": a.top_s}
                for name, a in _AGGREGATES.items()}


def reset_timings() -> None:
    with _AGGREGATES_LOCK:
        _AGGREGATES.clear()


def report() -> str:
    lines = [f"{'stage':<32} {'count':>5} {'mean ms':>10} {'total s':>9}"]
    for name, s in sorted(timings().items()):
        lines.append(f"{name:<32} {s['count']:>5} {s['mean_ms']:>10.2f} "
                     f"{s['total_s']:>9.2f}")
    return "\n".join(lines)


def _host_read(value) -> np.ndarray:
    """A host copy of ``value``: for a tensor on the card, a read that
    waits for the work queued before it."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def device_timer(fn: Callable, make_input: Callable[[int], tuple],
                 pull: Callable, iters: int = 4,
                 warmup: int = 1) -> float:
    """Steady-state seconds per call of ``fn``.

    make_input(i) -> args tuple (distinct per call); pull(result) -> a
    small value of the result. When that value is a tensor on the card,
    the calls are timed with CUDA events on its stream; otherwise on the
    host clock, up to a host read of the last call's value."""
    r = None
    for i in range(warmup):
        r = fn(*make_input(i))
        _host_read(pull(r))
    probe = pull(r) if r is not None else None
    if isinstance(probe, torch.Tensor) and probe.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            r = fn(*make_input(warmup + i))
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1000.0 / iters
    t0 = time.perf_counter()
    for i in range(iters):
        r = fn(*make_input(warmup + i))
    _host_read(pull(r))
    return (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# Roofline accounting
# ---------------------------------------------------------------------------

# Published peaks (NVIDIA's data sheet, dense, at the full 700 W) keyed by
# a substring of ``torch.cuda.get_device_name()``: "NVIDIA H100 80GB HBM3"
# is the SXM part. FP32 outside the tensor cores, bf16 in them; HBM3.
DEVICE_PEAKS = {
    "h100 80gb hbm3": {"chip": "H100 SXM", "fp32_tflops": 67.0,
                       "bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}
_PEAK_OF_DTYPE = {torch.float32: "fp32_tflops",
                  torch.bfloat16: "bf16_tflops"}


def device_peaks(device=None) -> Optional[Dict[str, float]]:
    """Peak FLOP/s and bandwidth of ``device`` (default: CUDA device 0),
    or None for a device not in ``DEVICE_PEAKS`` or without a card."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device if device is not None else 0)
    for key, peaks in DEVICE_PEAKS.items():
        if key in name.lower():
            return dict(peaks)
    return None


def roofline(flops: float, bytes_accessed: float, seconds: float,
             device=None, dtype: torch.dtype = torch.float32
             ) -> Dict[str, float]:
    """Achieved vs peak for one timed kernel/program.

    Returns achieved TFLOP/s and GB/s plus percent-of-peak numbers and
    which roof binds (higher fraction of its peak). The FLOP peak is the
    one of ``dtype``'s operations (float32 or bfloat16)."""
    out = {
        "achieved_tflops": flops / seconds / 1e12,
        "achieved_gbps": bytes_accessed / seconds / 1e9,
    }
    peaks = device_peaks(device)
    if peaks:
        out["chip"] = peaks["chip"]
        out["pct_peak_flops"] = 100.0 * out["achieved_tflops"] / \
            peaks[_PEAK_OF_DTYPE[dtype]]
        out["pct_peak_bw"] = 100.0 * out["achieved_gbps"] / \
            peaks["hbm_gbps"]
        out["bound"] = ("compute" if out["pct_peak_flops"]
                        >= out["pct_peak_bw"] else "memory")
    return out


def column_kernel_work(points: float, slots: float, occupied: float,
                       columns: float, pairs: float, core_pairs: float,
                       core_scan: float, changed: float
                       ) -> Dict[str, Tuple[float, float]]:
    """(bytes, operations) that each column-table kernel must spend on one
    table: each input read once and each output written once, as far as
    the data needs them; 9 operations a pair test. ``chip_smoke.py`` bounds
    the kernels by these counts of its run's table.

    points: stream length; slots: the table's 16-byte slots; occupied: the
    points placed; columns: the table's columns; pairs: the pair tests of
    one neighbourhood pass, core_pairs those from core points; core_scan:
    the slots (and end markers) the core points' columns hold; changed:
    the labels the propagation changes."""
    n = points
    return {
        # table written whole; order read, the placed points' xyz, the
        # column starts (which give each column's stream range and the
        # masked tail: no cell ids); stream slot and position written
        "table_fill": (16 * slots + 4 * n + 12 * occupied
                       + 4 * (columns + 1) + 8 * n, 0.0),
        # stream positions read, the placed points' values, out written,
        # and the cluster count (the ranks need no bytes of their own
        # from DRAM: a design can keep them on chip)
        "dense_tail": (4 * n + 4 * occupied + 4 * n + 4, 0.0),
        # the occupied slots (each column's occupancy from its start, so
        # no end marker and no stream slot), the column starts, out
        "column_counts": (16 * occupied + 4 * (columns + 1) + 4 * n,
                          9.0 * pairs),
        # and the placed points' labels
        "border_min": (16 * occupied + 4 * (columns + 1) + 4 * occupied
                       + 4 * n, 9.0 * pairs),
        # stream slots, the placed points' labels and the slots the core
        # points scan read once, each label that changes written once; a
        # pair test per core point and slot it scans (one pass reaches the
        # fixpoint)
        "propagate": (4 * n + 4 * occupied + 16 * core_scan + 4 * changed,
                      9.0 * core_pairs),
    }


def radius_count_work(centres: float, people: float,
                      pairs: float) -> Tuple[float, float]:
    """(bytes, operations) of ``radius_count``: centres (8 bytes) and
    people (8 bytes and a mask byte) read once, counts written once; 6
    operations (2 differences, 2 products, a sum, a compare) a pair test.
    ``chip_smoke.py`` bounds the kernel by these counts."""
    return (centres * 8 + people * 9 + centres * 4, 6.0 * pairs)


def eps_edges_work(points: float, dims: int, valid: float,
                   edges: float) -> Tuple[float, float]:
    """(bytes, operations) of ``eps_edges``: the points (4 D bytes) and the
    mask (a byte) read once, the offsets (8 bytes a point) and the
    columns (4 bytes an edge) written once; 9 operations (3 differences,
    3 products, 2 sums, a compare) a pair of valid points, tested once.
    None of them fuses, so ``chip_smoke.py`` bounds the kernel by these
    counts at the FP32 lanes' instruction rate."""
    return (points * (4 * dims + 1) + (points + 1) * 8 + edges * 4,
            9.0 * valid * valid)


# the column kernels that ``Pipeline.analyze`` launches on the card
CLUSTERING_KERNELS = ("table_fill", "column_counts", "propagate",
                      "border_min", "dense_tail")


def pipeline_stage_costs(n_points: int, n_people: int,
                         table_slots: int, column_cap: int, pyp: int,
                         grid_cells: int, bucket_cap: int,
                         gs_groups: int = 2) -> Dict[str, Dict[str, float]]:
    """Modeled MINIMUM work of the port's dominant pipeline stages: the
    operations that must execute and the device bytes that must move, each
    array read once and written once. The kernels' terms are
    ``column_kernel_work`` and ``radius_count_work``, the counts
    ``chip_smoke.py``'s bounds use, here at uniform occupancy with every
    point placed in the column table and every point core.

    Terms (S = table_slots, 16-byte slots (x, y, z, stream position);
    C = S / column_cap columns; n = points, k = people cap;
    pyp = the table's y extent in columns, unused by the counts;
    gs_groups = the JAX package's pass groups, unused: the union-find
    makes one pass):
      clustering  the cell sort (cell ids and order, 2 lanes rw), then
                  ``CLUSTERING_KERNELS``: n x 9 x (n / C) pair tests a
                  pass, n + C slots and end markers scanned, n labels
                  changed.
      extract_people  stable sort of labels (2 lanes rw), xyz gathered,
                  float64 prefix sums of 3 channels rw, k centroids
                  written; 6 operations a point.
      density     ``radius_count`` below 2^32 cell x people pairs (every
                  cell against every person), the bucketed count above it
                  (9 x bucket_cap pair tests a cell, 6 operations each).
    """
    n, k, S = float(n_points), float(n_people), float(table_slots)
    cells = float(grid_cells)
    columns = S / float(column_cap)
    f32, i32, f64 = 4.0, 4.0, 8.0
    pairs = n * 9.0 * (n / columns)
    work = column_kernel_work(n, S, min(n, S), columns, pairs, pairs,
                              min(n + columns, S), n)
    clustering_bytes = 2 * 2 * i32 * n + sum(
        work[name][0] for name in CLUSTERING_KERNELS)
    clustering_flops = sum(work[name][1] for name in CLUSTERING_KERNELS)

    people_bytes = 2 * 2 * i32 * n + 3 * f32 * n + 2 * 3 * f64 * n \
        + (2 * f32 + 1) * k
    people_flops = 6.0 * n

    if cells * k < 2.0 ** 32:
        density_bytes, density_flops = radius_count_work(cells, k, cells * k)
    else:
        density_flops = 6.0 * 9 * bucket_cap * cells
        density_bytes = (2 * f32 + 1) * k + f32 * cells

    return {
        "clustering": {"flops": clustering_flops,
                       "bytes": clustering_bytes},
        "extract_people": {"flops": people_flops, "bytes": people_bytes},
        "density": {"flops": density_flops, "bytes": density_bytes},
    }
