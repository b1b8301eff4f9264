"""The port's venue-scale clustering (``ops/ccl.py`` and the plain versions
of the five column-table kernels in ``ops/cuda/columns.py``) against the
JAX package's, on the CPU.

The JAX Pallas kernels run in interpret mode, as tests/test_fill.py and
tests/test_clustering.py run them. The two tables have different layouts
(the JAX package's is (rows, slots, 128-lane y), the port's (x, y, slot),
with its per-point values in stream order), so everything is compared per
point. Tolerance: none; slots, counts,
labels, cluster counts and overflow are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.ops import ccl as jccl
from lidar_ai_recommendation_software_tpu.ops import clustering as jcl
from lidar_ai_recommendation_software_tpu.ops.pallas import fill as jfill
from lidar_ai_recommendation_software_tpu_torch.ops import ccl as tccl
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
    columns as C)

INT_MAX = C.INT_MAX
# the kernel tests' table: 16 x 16 columns of 16 slots, which some 40 of
# the 700 points overflow (JAX interpret mode costs seconds per call, so
# the venue is small)
NCX = NCY = 16
CAP = 16
EPS = 0.35
MIN_SAMPLES = 5
# a pair whose float32 squared distance is float32(0.35 * 0.35), one ulp
# above float32(0.35) ** 2: not neighbours under the JAX package's
# rounding of eps^2, neighbours under a float64 one
PAIR = np.float32([[0.0, 0.0, 5.0], [0.3354102, 0.1, 5.0]])


def _venue(seed=7, n=1500, cap=2048, extent=10.0, blobs=40, spread=0.1,
           background=0.0):
    """Blobs of people (as tests/test_clustering.py's
    test_dbscan_gs_matches_columns_and_sklearn) and a share of uniform
    background, padded to ``cap`` with about 5% of the points masked out
    at random."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-extent, extent, (blobs, 2))
    nb = int(n * (1 - background))
    pts = np.zeros((cap, 3), np.float32)
    pts[:nb, :2] = centers[rng.randint(0, blobs, nb)] + rng.normal(
        0, spread, (nb, 2))
    pts[nb:n, :2] = rng.uniform(-extent, extent, (n - nb, 2))
    pts[:n, 2] = rng.uniform(0, 1.8, n)
    mask = np.zeros(cap, bool)
    mask[:n] = rng.rand(n) > 0.05
    return pts, mask


@pytest.fixture(scope="module")
def both():
    """One venue through both packages' table and kernels: the JAX
    package's stream planes, counts, propagated labels, border minimum
    and extracted values; the port's the same, from its plain versions."""
    pts, mask = _venue(n=700, cap=1024, extent=3.0, blobs=12, spread=0.2,
                       background=0.3)
    pts[-2:] = PAIR
    mask[-2:] = True
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    planes = jccl.build_planes_stream(jp, jm, min_cell=EPS, ncx=NCX,
                                      ncy=NCY, cap=CAP)
    j = {"planes": planes}
    counts = jccl.column_counts_planes(planes, EPS)
    j["counts"] = jnp.pad(counts, ((1, 1), (0, 0), (0, 0)))
    core = (planes.ptidx >= 0) & (j["counts"] >= MIN_SAMPLES)
    j["labels0"] = jnp.where(core, planes.ptidx, jccl.INT_MAX)
    labels = j["labels0"]
    for _ in range(5):  # to a last pass that changes nothing
        labels, changed, _ = jccl.gs_passes(
            (planes.xs, planes.ys, planes.zs), labels, EPS, npass=6)
        if int(np.asarray(changed)[-1].sum()) == 0:
            break
    assert int(np.asarray(changed)[-1].sum()) == 0
    j["labels"] = labels
    j["border"] = jnp.pad(jccl.border_min_planes(planes, labels, EPS),
                          ((1, 1), (0, 0), (0, 0)),
                          constant_values=jccl.INT_MAX)
    j["extract"] = jfill.extract_stream(
        jnp.where(planes.ptidx >= 0, (3 * planes.ptidx + 7).astype(
            jnp.float32), 0.0), planes.srow, planes.sy, planes.slots)
    j = {k: (v if k == "planes" else np.asarray(v)) for k, v in j.items()}

    t = tccl.build_table(torch.from_numpy(pts), torch.from_numpy(mask), EPS,
                         NCX, NCY, CAP)
    return pts, mask, j, t


def _jax_per_point(planes, arr, n):
    """Per point: the JAX table entry (row, slot, lane) of its slot, and
    whether it has one."""
    sidx = np.asarray(planes.sidx)
    srow, sy = np.asarray(planes.srow), np.asarray(planes.sy)
    slots = np.asarray(planes.slots)
    px, cap = planes.xs.shape[0], planes.xs.shape[1]
    placed = (srow < px) & (slots < cap)
    out = np.full(n, -999, arr.dtype)
    out[sidx[placed]] = arr[srow[placed], slots[placed], sy[placed]]
    has = np.zeros(n, bool)
    has[sidx[placed]] = True
    return out, has


def _port_slot(t):
    """Per point: its slot in the port's table, -1 where it has none."""
    pst, ss = t.point_stream.numpy(), t.stream_slot.numpy()
    return np.where(pst >= 0, ss[np.maximum(pst, 0)], -1)


def _port_per_point(t, stream_values):
    """Per point: the port's value, kept in stream order."""
    pst = t.point_stream.numpy()
    out = np.full(len(pst), -999, stream_values.dtype)
    out[pst >= 0] = stream_values[pst[pst >= 0]]
    return out


def test_table_build_matches_fill_planes(both):
    pts, mask, j, t = both
    planes = j["planes"]
    n = len(pts)
    jidx, jhas = _jax_per_point(planes, np.asarray(planes.ptidx), n)
    ps = _port_slot(t)
    np.testing.assert_array_equal(ps >= 0, jhas)
    assert jhas.sum() > 500
    # same column (row, lane) and slot for every placed point
    srow, sy = np.asarray(planes.srow), np.asarray(planes.sy)
    slots, sidx = np.asarray(planes.slots), np.asarray(planes.sidx)
    order = np.argsort(sidx)
    col, slot = ps // CAP, ps % CAP
    np.testing.assert_array_equal(col[jhas] // (NCY + 2), srow[order][jhas])
    np.testing.assert_array_equal(col[jhas] % (NCY + 2), sy[order][jhas])
    np.testing.assert_array_equal(slot[jhas], slots[order][jhas])
    # the same x, y, z and point index in the slot
    tab = t.table.numpy()
    for lane, plane in enumerate((planes.xs, planes.ys, planes.zs)):
        jv, _ = _jax_per_point(planes, np.asarray(plane), n)
        np.testing.assert_array_equal(tab[ps[jhas], lane], jv[jhas])
    spos = C.slot_stream_pos(t.table).numpy()
    np.testing.assert_array_equal(t.order.numpy()[spos[ps[jhas]]],
                                  jidx[jhas])
    assert int(t.overflow) == int(planes.overflow) > 0
    # empty slots: EMPTY_COORD and -1, as the JAX planes
    empty = spos < 0
    assert (tab[empty, :3] == C.EMPTY_COORD).all()
    assert empty.sum() == t.table.shape[0] - jhas.sum()


def test_gather_matches_extract_stream(both):
    pts, mask, j, t = both
    planes = j["planes"]
    values = torch.where(t.stream_slot >= 0, 3 * t.order + 7, 0)
    got = C.table_gather(values, t.point_stream, 0).numpy()
    want = np.zeros(len(pts), np.int64)
    want[np.asarray(planes.sidx)] = j["extract"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, C.table_gather_reference(values, t.point_stream, 0).numpy())


def test_counts_match_column_counts_planes(both):
    pts, mask, j, t = both
    counts = C.column_counts(t.table, t.stream_slot, t.cell_start, t.py,
                              t.cap, EPS)
    want, has = _jax_per_point(j["planes"], j["counts"], len(pts))
    got = _port_per_point(t, counts.numpy())
    np.testing.assert_array_equal(got[has], want[has])
    assert (got[has] >= MIN_SAMPLES).sum() > 200
    # the PAIR is one ulp past eps under float32 rounding: no neighbours
    assert got[-2] == got[-1] == 1


def test_eps_squared_rounds_like_the_ccl_kernels():
    e = np.float32(EPS)
    d2 = np.float32(PAIR[1, 0] * PAIR[1, 0] + PAIR[1, 1] * PAIR[1, 1])
    assert C.eps_sq(EPS) == e * e < d2 == np.float32(EPS * EPS)
    want = np.asarray(jnp.asarray([EPS], jnp.float32) ** 2)[0]
    assert C.eps_sq(EPS) == want


def _initial_labels(t):
    """Stream-order labels before the propagation: a core point's index,
    INT_MAX elsewhere."""
    counts = C.column_counts(t.table, t.stream_slot, t.cell_start, t.py,
                              t.cap, EPS)
    core = (t.stream_slot >= 0) & (counts >= MIN_SAMPLES)
    return torch.where(core, t.order, INT_MAX)


def test_propagation_matches_gs_passes_fixpoint(both):
    pts, mask, j, t = both
    labels = _initial_labels(t)
    j0, has = _jax_per_point(j["planes"], j["labels0"], len(pts))
    np.testing.assert_array_equal(_port_per_point(t, labels.numpy())[has],
                                  j0[has])
    sweeps = C.propagate(t.table, t.stream_slot, t.point_stream, t.py, t.cap,
                         EPS, labels, 40)
    assert 1 < sweeps < 40
    want, _ = _jax_per_point(j["planes"], j["labels"], len(pts))
    got = _port_per_point(t, labels.numpy())
    np.testing.assert_array_equal(got[has], want[has])
    assert len(np.unique(got[has & (got != INT_MAX)])) > 5


def test_propagation_raises_at_its_sweep_bound(both):
    """A bound that stops the propagation before its fixpoint raises
    rather than return labels that are not final; one more sweep is
    enough."""
    _, _, _, t = both
    args = (t.table, t.stream_slot, t.point_stream, t.py, t.cap, EPS)
    sweeps = C.propagate(*args, _initial_labels(t), 40)
    labels = _initial_labels(t)
    with pytest.raises(RuntimeError, match="did not reach its fixpoint"):
        C.propagate(*args, labels, sweeps - 1)
    assert C.propagate(*args, labels, sweeps) == sweeps


def test_border_min_matches_border_min_planes(both):
    pts, mask, j, t = both
    labels = torch.full((len(pts),), INT_MAX, dtype=torch.int32)
    pst = t.point_stream
    jl, has = _jax_per_point(j["planes"], j["labels"], len(pts))
    labels[pst[torch.from_numpy(has)].long()] = torch.from_numpy(jl[has])
    got = C.border_min(t.table, t.stream_slot, t.cell_start, t.py, t.cap,
                       EPS, labels)
    want, _ = _jax_per_point(j["planes"], j["border"], len(pts))
    got = _port_per_point(t, got.numpy())
    np.testing.assert_array_equal(got[has], want[has])
    border = has & (jl == INT_MAX) & (want != INT_MAX)
    assert border.sum() > 10  # non-core points that adopt a core label


@pytest.mark.parametrize("eps,cap,overflows", [(0.35, 64, False),
                                               (0.3, 64, False),
                                               (0.35, 4, True)],
                         ids=["eps0.35", "eps0.3", "column_overflow"])
def test_dbscan_gs_matches_dbscan_columns(eps, cap, overflows):
    pts, mask = _venue()
    want, wn, wov = jcl.dbscan_columns(jnp.asarray(pts), jnp.asarray(mask),
                                       eps, MIN_SAMPLES, ncx=64, ncy=64,
                                       column_cap=cap)
    got, gn, gov = tccl.dbscan_gs(torch.from_numpy(pts),
                                  torch.from_numpy(mask), eps, MIN_SAMPLES,
                                  ncx=64, ncy=64, column_cap=cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gn) == int(wn) > 20
    assert int(gov) == int(wov)
    assert (int(gov) > 0) == overflows


def test_dbscan_gs_matches_jax_dbscan_gs(both):
    """Against the Pallas Gauss-Seidel CCL itself (interpret mode)."""
    pts, mask, _, _ = both
    want, wn, wov = jccl.dbscan_gs(jnp.asarray(pts), jnp.asarray(mask), EPS,
                                   MIN_SAMPLES, ncx=NCX, ncy=NCY,
                                   column_cap=CAP)
    got, gn, gov = tccl.dbscan_gs(torch.from_numpy(pts),
                                  torch.from_numpy(mask), EPS, MIN_SAMPLES,
                                  ncx=NCX, ncy=NCY, column_cap=CAP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gn) == int(wn) > 5
    assert int(gov) == int(wov) > 0


def test_cpu_tensors_never_build_the_kernels(monkeypatch):
    """CPU tensors take the plain versions without touching the CUDA
    build (which this machine cannot do) or the launch counts."""
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels

    def no_build():
        raise AssertionError("CPU path tried to build the CUDA kernels")
    monkeypatch.setattr(C, "load_library", no_build)
    before = dict(kernels.LAUNCHES)
    pts, mask = _venue(n=300, cap=512)
    tccl.dbscan_gs(torch.from_numpy(pts), torch.from_numpy(mask), EPS,
                   MIN_SAMPLES, ncx=NCX, ncy=NCY, column_cap=CAP)
    assert kernels.LAUNCHES == before
