"""The port's ``place_dense`` and its centroid route against the JAX
package (the Pallas kernel runs in interpret mode on the CPU).

Tolerances: ``place_dense`` copies values, so whole arrays are bit-equal.
The centroid sums go through float64 prefixes split into (hi, lo) float32
pairs where the JAX package scans such pairs in another order: counts are
exact, sums agree within 2e-3 at coordinates of +-30 m over 20,000 rows
(the bound the JAX package's own test allows between its two routes), and
the port's two routes agree within 1e-5 on the centroids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.ops import clustering as jcl
from lidar_ai_recommendation_software_tpu.ops.pallas import fill
from lidar_ai_recommendation_software_tpu_torch.ops import clustering as tcl
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import place

SUM_TOL = 2e-3
CENTROID_TOL = 1e-5


def _segments(seed, n, k):
    """Sorted ids with one end row per segment and two value channels, the
    case of the JAX package's own exact-placement test."""
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.randint(0, k, n)).astype(np.int32)
    is_end = np.concatenate([ids[1:] != ids[:-1], [True]])
    vals = [rng.uniform(-1e4, 1e4, n).astype(np.float32),
            rng.randint(0, 1 << 24, n).astype(np.float32)]
    return ids, is_end, vals


def test_place_dense_bit_equal_to_jax():
    ids, is_end, vals = _segments(3, 4000, 700)
    jout, jocc = fill.place_dense(jnp.asarray(ids), jnp.asarray(is_end),
                                  [jnp.asarray(v) for v in vals], 700,
                                  lanes=256, tile=128)
    out, occ = place.place_dense(torch.from_numpy(ids),
                                 torch.from_numpy(is_end),
                                 [torch.from_numpy(v) for v in vals], 700,
                                 lanes=256)
    assert out.shape == (2, 768) and occ.shape == (768,)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert occ.sum() == is_end.sum()


@pytest.mark.parametrize("case", ["empty_valid", "every_slot", "ids_past_k",
                                  "negative_id"])
def test_place_dense_edges(case):
    """No valid row, every slot hit, and ids outside [0, K'): clipped into
    the first or last slot, as the JAX function clips them."""
    k, lanes = 6, 8
    ids = np.arange(8, dtype=np.int32)
    valid = np.ones(8, bool)
    if case == "empty_valid":
        valid[:] = False
    elif case == "ids_past_k":
        ids = np.array([0, 1, 2, 3, 4, 5, 6, 40], np.int32)
    elif case == "negative_id":
        ids = np.array([-5, 1, 2, 3, 4, 5, 6, 7], np.int32)
    vals = np.arange(1.0, 9.0, dtype=np.float32)[None]
    out, occ = place.place_dense(torch.from_numpy(ids),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(vals), k, lanes=lanes)
    jout, jocc = fill.place_dense(jnp.asarray(ids), jnp.asarray(valid),
                                  [jnp.asarray(vals[0])], k, lanes=lanes,
                                  tile=8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    if case == "empty_valid":
        assert not out.any() and not occ.any()
    else:
        assert occ.all()
        assert out[0, 7] == 8.0 and out[0, 0] == 1.0


def test_place_dense_takes_a_channel_tensor_or_a_sequence():
    ids, is_end, vals = _segments(5, 300, 40)
    args = (torch.from_numpy(ids), torch.from_numpy(is_end))
    a = place.place_dense(*args, [torch.from_numpy(v) for v in vals], 40)
    b = place.place_dense(*args, torch.from_numpy(np.stack(vals)), 40)
    assert a[0].shape == (2, place.LANES)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _labelled_cloud():
    rng = np.random.RandomState(7)
    n, n_clusters, k = 20_000, 153, 256
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    labels = rng.randint(-1, n_clusters, n).astype(np.int32)
    return pts, labels, n_clusters, k


def test_centroids_sorted_matches_jax_and_has_no_phantom_slots():
    pts, labels, n_clusters, k = _labelled_cloud()
    seg = np.where(labels >= 0, labels, k).astype(np.int32)
    jsums, jcnts = jcl._centroids_sorted(jnp.asarray(pts), jnp.asarray(seg),
                                         k)
    sums, cnts = tcl._centroids_sorted(
        torch.from_numpy(pts), torch.from_numpy(seg).to(torch.int64), k)
    sums, cnts = sums.numpy(), cnts.numpy()
    assert cnts[n_clusters:].sum() == 0
    assert np.abs(sums[n_clusters:]).sum() == 0
    np.testing.assert_array_equal(cnts, np.asarray(jcnts))
    np.testing.assert_array_equal(cnts[:n_clusters],
                                  np.bincount(labels[labels >= 0],
                                              minlength=n_clusters))
    np.testing.assert_allclose(sums, np.asarray(jsums), atol=SUM_TOL)


@pytest.mark.parametrize("k", [256, 100])
def test_cluster_centroids_routes_agree(monkeypatch, k):
    """Above ``SEGSUM_MAX_POINTS`` rows ``cluster_centroids`` takes the
    ``place_dense`` route; it gives what the other route gives, the
    overflow count (153 clusters into 100 slots) included."""
    pts, labels, n_clusters, _ = _labelled_cloud()
    p, lab = torch.from_numpy(pts), torch.from_numpy(labels)
    want = tcl.cluster_centroids(p, lab, k)
    calls = []
    plain = tcl.place_dense
    monkeypatch.setattr(tcl, "place_dense",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    assert not calls
    monkeypatch.setattr(tcl, "SEGSUM_MAX_POINTS", 1000)
    got = tcl.cluster_centroids(p, lab, k)
    assert calls == [1]
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert int(got[2]) == int(want[2]) == max(0, n_clusters - k)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                               atol=CENTROID_TOL)
    jc, jv, jo = jcl.cluster_centroids(jnp.asarray(pts), jnp.asarray(labels),
                                       k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jv))
    assert int(jo) == int(got[2])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jc),
                               atol=CENTROID_TOL)


def test_segsum_switch_is_the_jax_packages():
    assert tcl.SEGSUM_MAX_POINTS == jcl.SEGSUM_MAX_POINTS == 2_097_152
