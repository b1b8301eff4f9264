"""The plain versions of the port's ``fps`` and ``sa_mlp_pool`` kernels,
and the sampling and grouping ops around them, against the JAX package on
the CPU (its Pallas kernels run in interpret mode).

Tolerances: indices (FPS selections, neighbour indices, keep masks) are
exact. ``sa_mlp_pool`` in float32 agrees within rtol 1e-5 / atol 1e-5 (the
inner sums run in another order); with bfloat16 operands within 2e-2: a sum
that lands an ulp apart before it is rounded to bfloat16 for the next layer
moves that operand by 2^-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.ops import grouping as jgr
from lidar_ai_recommendation_software_tpu.ops import sampling as jsm
from lidar_ai_recommendation_software_tpu.ops.pallas import kernels as pk
from lidar_ai_recommendation_software_tpu_torch.ops import grouping as tgr
from lidar_ai_recommendation_software_tpu_torch.ops import sampling as tsm
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
    pointnet as tpn)

BF16_TOL = 2e-2


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# fps
# ---------------------------------------------------------------------------

def _fps_case(name):
    rng = np.random.RandomState(2)
    if name == "masked_tail":
        return (rng.uniform(-5, 5, (256, 3)).astype(np.float32),
                np.arange(256) < 200, 32)
    if name == "line":
        return (np.stack([np.linspace(0, 10, 128), np.zeros(128),
                          np.zeros(128)], 1).astype(np.float32),
                np.ones(128, bool), 4)
    if name == "fewer_valid_than_samples":
        return (rng.uniform(-5, 5, (64, 3)).astype(np.float32),
                np.arange(64) % 9 == 4, 20)
    if name == "lattice_ties":
        i, j = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
        return (np.stack([i.ravel(), j.ravel(), np.zeros(64)], 1)
                .astype(np.float32), np.ones(64, bool), 16)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["masked_tail", "line",
                                  "fewer_valid_than_samples",
                                  "lattice_ties"])
def test_fps_single_matches_jax(name):
    pts, mask, m = _fps_case(name)
    want = np.asarray(pk.fps(jnp.asarray(pts), jnp.asarray(mask), m))
    twin = np.asarray(jsm.farthest_point_sampling(
        jnp.asarray(pts), jnp.asarray(mask), m))
    np.testing.assert_array_equal(want, twin)
    for fn in (tpn.fps_reference, tpn.fps_single, tpn.fps,
               tsm.farthest_point_sampling):
        got = fn(_t(pts), _t(mask), m)
        assert got.dtype == torch.int32 and got.shape == (m,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)
    if name == "line":
        assert 0 in want and 127 in want
    if name == "fewer_valid_than_samples":
        chosen = tpn.fps_single(_t(pts), _t(mask), m).numpy()
        assert chosen[0] == 0 and mask[chosen[1:]].all()
        assert len(set(chosen[1:])) == mask.sum()  # then they repeat


def test_fps_batched_matches_single_and_jax():
    rng = np.random.RandomState(3)
    pts = rng.uniform(-5, 5, (4, 300, 3)).astype(np.float32)
    mask = rng.rand(4, 300) > 0.15
    want = np.asarray(pk.fps(jnp.asarray(pts), jnp.asarray(mask), 24))
    got = tpn.fps_batched(_t(pts), _t(mask), 24)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpn.fps(_t(pts), _t(mask), 24).numpy(),
                                  want)
    singles = np.stack([tpn.fps_single(_t(pts[i]), _t(mask[i]), 24).numpy()
                        for i in range(4)])
    np.testing.assert_array_equal(singles, want)


def test_fps_start_index_is_kept_whatever_the_mask_says():
    pts, _, _ = _fps_case("masked_tail")
    mask = np.arange(256) >= 100          # point 7 is masked
    want = np.asarray(pk._fps_single(jnp.asarray(pts), jnp.asarray(mask), 12,
                                     7))
    got = tpn.fps_single(_t(pts), _t(mask), 12, start_index=7).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 7 and mask[got[1:]].all()


def test_fps_batched_of_one_cloud_is_fps_single():
    pts, mask, m = _fps_case("masked_tail")
    out = tpn.fps_batched(_t(pts)[None], _t(mask)[None], m)
    assert out.shape == (1, m)
    assert torch.equal(out[0], tpn.fps_single(_t(pts), _t(mask), m))


# ---------------------------------------------------------------------------
# sa_mlp_pool
# ---------------------------------------------------------------------------

def _sa_case(seed, m, k, cin, hidden, bias_scale=0.1):
    rng = np.random.RandomState(seed)
    grouped = rng.randn(m, k, cin).astype(np.float32)
    valid = rng.rand(m, k) > 0.3
    valid[m // 2] = False                 # one centroid with no neighbour
    dims = [cin] + list(hidden)
    weights = [((rng.randn(a, b) * 0.2).astype(np.float32),
                (rng.randn(b) * bias_scale).astype(np.float32))
               for a, b in zip(dims[:-1], dims[1:])]
    return grouped, valid, weights


def _both(grouped, valid, weights, bf16=False):
    want = pk.sa_mlp_pool(
        jnp.asarray(grouped), jnp.asarray(valid),
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights], tile=32,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tw = [(_t(w), _t(b)) for w, b in weights]
    dtype = torch.bfloat16 if bf16 else torch.float32
    got = tpn.sa_mlp_pool(_t(grouped), _t(valid), tw, compute_dtype=dtype)
    ref = tpn.sa_mlp_pool_reference(_t(grouped), _t(valid), tw, dtype)
    assert torch.equal(got, ref)          # CPU tensors take the plain version
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("shape", [(100, 16, 6, (16, 16, 32)),
                                   (40, 32, 3, (32, 32, 64)),
                                   (24, 32, 67, (64, 64, 128))],
                         ids=["pallas_test", "sa1", "sa2"])
def test_sa_mlp_pool_f32_matches_jax(shape):
    m, k, cin, hidden = shape
    grouped, valid, weights = _sa_case(1, m, k, cin, hidden)
    got, want = _both(grouped, valid, weights)
    assert got.shape == (m, hidden[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[m // 2].any()          # the empty neighbourhood is 0
    jref = np.asarray(pk.sa_mlp_pool_reference(
        jnp.asarray(grouped), jnp.asarray(valid),
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights]))
    np.testing.assert_allclose(got, jref, rtol=1e-5, atol=1e-5)


def test_sa_mlp_pool_bf16_matches_jax():
    grouped, valid, weights = _sa_case(4, 40, 32, 3, (32, 32, 64))
    got, want = _both(grouped, valid, weights, bf16=True)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    f32, _ = _both(grouped, valid, weights)
    assert np.abs(got - f32).max() > 1e-4  # the operands really are rounded


def test_sa_mlp_pool_empty_neighbourhood_zeroed():
    m, k = 8, 4
    grouped = np.ones((m, k, 3), np.float32)
    valid = np.zeros((m, k), bool)
    valid[0] = True
    weights = [(np.eye(3, 8, dtype=np.float32), np.zeros(8, np.float32)),
               (np.eye(8, dtype=np.float32), np.zeros(8, np.float32)),
               (np.eye(8, dtype=np.float32), np.zeros(8, np.float32))]
    got, want = _both(grouped, valid, weights)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[1:] == 0.0) and np.any(got[0] != 0.0)


def test_sa_mlp_pool_refuses_what_it_is_not():
    grouped, valid, weights = _sa_case(1, 4, 4, 3, (8, 8, 8))
    tw = [(_t(w), _t(b)) for w, b in weights]
    with pytest.raises(ValueError, match="3 MLP layers"):
        tpn.sa_mlp_pool(_t(grouped), _t(valid), tw[:2])
    with pytest.raises(ValueError, match="compute_dtype"):
        tpn.sa_mlp_pool(_t(grouped), _t(valid), tw,
                        compute_dtype=torch.float16)


# ---------------------------------------------------------------------------
# grouping and sampling
# ---------------------------------------------------------------------------

def test_ball_group_first_k_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    q, qm = pts[:128], np.arange(128) % 11 != 3
    pm = np.arange(3000) % 7 != 0
    for chunk in (512, 50):               # one chunk, and ragged chunks
        jidx, jval = jgr.ball_group(jnp.asarray(q), jnp.asarray(qm),
                                    jnp.asarray(pts), jnp.asarray(pm), 0.8,
                                    16)
        idx, val = tgr.ball_group(_t(q), _t(qm), _t(pts), _t(pm), 0.8, 16,
                                  chunk=chunk)
        assert idx.dtype == torch.int32 and val.dtype == torch.bool
        np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert not val[3].any() and (idx[3] == 0).all()   # a masked query
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    hits = np.nonzero((d2[0] <= 0.8 * 0.8) & pm)[0][:16]
    assert (idx[0][val[0]].numpy() == hits).all()


def test_ball_group_masks_empty_and_features():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    feats = rng.randn(500, 5).astype(np.float32)
    pmask = np.arange(500) < 400
    q = np.array([[0.0, 0.0, 0.0], [100.0, 100.0, 100.0]], np.float32)
    idx, val = tgr.ball_group(_t(q), torch.ones(2, dtype=torch.bool),
                              _t(pts), _t(pmask), 1.0, 8, method="dense")
    jidx, jval = jgr.ball_group(jnp.asarray(q), jnp.ones(2, bool),
                                jnp.asarray(pts), jnp.asarray(pmask), 1.0, 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    assert (idx[0][val[0]] < 400).all() and not val[1].any()
    for f in (None, feats):
        g = tgr.group_features(_t(pts), None if f is None else _t(f), _t(q),
                               idx, val)
        jg = jgr.group_features(jnp.asarray(pts),
                                None if f is None else jnp.asarray(f),
                                jnp.asarray(q), jidx, jval)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        assert g[1].sum() == 0.0


@pytest.mark.parametrize("kw", [dict(method="hashgrid"), dict(method="auto")],
                         ids=["asked_for", "auto_above_the_dense_limit"])
def test_ball_group_hashgrid_is_not_ported(kw):
    """The hash-grid route, asked for and taken by "auto" above
    ``BRUTEFORCE_MAX_SOURCE`` sources: the JAX package's indices and
    validity bit for bit (``tests/test_torch_hashgrid.py`` holds the grid
    itself). The name stays from when the port raised
    ``NotImplementedError`` for this route."""
    n = 3000 if kw["method"] == "hashgrid" else tgr.BRUTEFORCE_MAX_SOURCE + 1
    assert tgr.BRUTEFORCE_MAX_SOURCE == jgr.BRUTEFORCE_MAX_SOURCE
    rng = np.random.RandomState(8)
    extent = (n / 3000) ** 0.5 * 5
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    pm = rng.rand(n) > 0.05
    q, qm = pts[:96], np.arange(96) % 13 != 5
    jidx, jval = jgr.ball_group(jnp.asarray(q), jnp.asarray(qm),
                                jnp.asarray(pts), jnp.asarray(pm), 0.6, 16,
                                **kw)
    idx, val = tgr.ball_group(_t(q), _t(qm), _t(pts), _t(pm), 0.6, 16, **kw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    assert val.sum() > 96 and not val[5].any()
    if kw["method"] == "auto":
        hidx, hval = tgr.ball_group(_t(q), _t(qm), _t(pts), _t(pm), 0.6, 16,
                                    method="hashgrid")
        assert torch.equal(idx, hidx) and torch.equal(val, hval)


def test_random_downsample_keeps_what_jax_keeps_for_the_same_uniforms():
    rng = np.random.RandomState(5)
    pts = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    mask = rng.rand(400) > 0.2
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(key, (400,)))
    for factor in (0.4, 1e-9):            # the second keeps the first valid
        _, jkeep = jsm.random_downsample(key, jnp.asarray(pts),
                                         jnp.asarray(mask), factor)
        keep = tsm.keep_from_uniforms(_t(u), _t(mask), factor)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert keep.sum() == 1 and keep[np.argmax(mask)]
    gen = torch.Generator().manual_seed(0)
    p, keep = tsm.random_downsample(gen, _t(pts), _t(mask), 0.5)
    assert p.shape == (400, 3) and not (keep & ~_t(mask)).any()
    assert 0.3 * mask.sum() < keep.sum() < 0.7 * mask.sum()
    whole = _t(mask)
    assert tsm.random_downsample(gen, _t(pts), whole, 1.0)[1] is whole


def test_voxel_downsample_matches_jax():
    rng = np.random.RandomState(6)
    pts = rng.uniform(-4, 4, (2000, 3)).astype(np.float32)
    mask = rng.rand(2000) > 0.1
    _, jkeep = jsm.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.5)
    _, keep = tsm.voxel_downsample(_t(pts), _t(mask), 0.5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < keep.sum() < mask.sum()
