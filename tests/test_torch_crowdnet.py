"""The port's CrowdNet against the JAX package's ``BatchedCrowdNet`` on
the CPU (``use_pallas=False``), with ``params_from_flax`` carrying the
parameters across: a seeded flax init at narrow width, and the shipped
checkpoint at its own width.

Tolerances: FPS and neighbour indices are exact. The outputs agree within
rtol 1e-4 / atol 1e-4, what the JAX package's own tests allow between its
two routes: the matrix products, the convolutions and the per-cell sums
(float64 prefixes here, sequential float32 adds there) round in another
order. With bfloat16 compute the operands are rounded at the same places,
but a sum an ulp apart moves a rounded operand by 2^-8 relative, so the
outputs are held within 5e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu import neural as jneural
from lidar_ai_recommendation_software_tpu.models import train as jtrain
from lidar_ai_recommendation_software_tpu.models.crowdnet import (
    BatchedCrowdNet)
from lidar_ai_recommendation_software_tpu.ops import grouping as jgr
from lidar_ai_recommendation_software_tpu.ops import sampling as jsm
from lidar_ai_recommendation_software_tpu.synthetic import sample_venue
from lidar_ai_recommendation_software_tpu_torch import neural as tneural
from lidar_ai_recommendation_software_tpu_torch.models import train as ttrain
from lidar_ai_recommendation_software_tpu_torch.models.crowdnet import (
    CrowdNet)

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
NARROW = dict(sa1_samples=64, sa2_samples=16, grid=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, b, n, n_valid):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-8, 8, (b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(0, 2, (b, n))
    mask = np.arange(n)[None, :] < np.asarray(n_valid)[:, None]
    vmin = np.tile(np.float32([-8.0, -8.0]), (b, 1))
    vsize = np.full(b, 16.0, np.float32)
    return pts, mask, vmin, vsize


@pytest.fixture(scope="module")
def narrow():
    """(inputs, flax variables, the port's model with them loaded)."""
    inputs = _batch(3, 2, 512, [480, 512])
    net = BatchedCrowdNet(use_pallas=False, **NARROW)
    variables = net.init(jax.random.PRNGKey(0),
                         *(jnp.asarray(x) for x in inputs))
    model = CrowdNet(**NARROW)
    model.load_state_dict(ttrain.params_from_flax(
        _np_tree(variables["params"])))
    return inputs, variables, model.eval()


def _torch_inputs(inputs):
    return tuple(torch.from_numpy(x) for x in inputs)


def test_params_from_flax_fills_every_parameter(narrow):
    _, variables, model = narrow
    state = ttrain.params_from_flax(_np_tree(variables["params"]))
    assert set(state) == set(model.state_dict())
    flax_count = sum(int(np.prod(v.shape)) for v in
                     jax.tree_util.tree_leaves(variables["params"]))
    assert sum(v.numel() for v in state.values()) == flax_count
    kernel = np.asarray(
        variables["params"]["VmapCrowdNet_0"]["bev"]["Conv_0"]["kernel"])
    assert kernel.shape == (3, 3, 201, 128)
    np.testing.assert_array_equal(
        state["bev.Conv_0.weight"].numpy(), kernel.transpose(3, 2, 0, 1))
    # the tree without the batching scope maps the same way
    bare = ttrain.params_from_flax(
        _np_tree(variables["params"]["VmapCrowdNet_0"]))
    assert all(torch.equal(bare[k], state[k]) for k in state)
    shapes = ttrain.expected_flax_shapes(model)
    leaves = ttrain.flax_leaves(
        _np_tree(variables["params"]["VmapCrowdNet_0"]))
    assert shapes == {p: v.shape for p, v in leaves.items()}


def test_sampling_and_grouping_indices_exact(narrow):
    inputs, _, model = narrow
    pts, mask, _, _ = inputs
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    idx1 = model.sa1.sample(tp, tm)
    c1, m1, gidx1, gval1, g1 = model.sa1.group(tp, None, tm, idx1)
    idx2 = model.sa2.sample(c1, m1)
    _, _, gidx2, gval2, g2 = model.sa2.group(c1, torch.zeros(2, 64, 64), m1,
                                             idx2)
    assert g2.shape == (2, 16, 32, 67)
    assert g1.shape == (2, 64, 32, 3)
    for b in range(2):
        p, m = jnp.asarray(pts[b]), jnp.asarray(mask[b])
        j1 = jsm.farthest_point_sampling(p, m, 64)
        np.testing.assert_array_equal(idx1[b].numpy(), np.asarray(j1))
        jc1, jm1 = p[j1], m[j1]
        ji, jv = jgr.ball_group(jc1, jm1, p, m, 0.4, 32)
        np.testing.assert_array_equal(gidx1[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(gval1[b].numpy(), np.asarray(jv))
        j2 = jsm.farthest_point_sampling(jc1, jm1, 16)
        np.testing.assert_array_equal(idx2[b].numpy(), np.asarray(j2))
        ji, jv = jgr.ball_group(jc1[j2], jm1[j2], jc1, jm1, 1.0, 32)
        np.testing.assert_array_equal(gidx2[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(gval2[b].numpy(), np.asarray(jv))


def test_narrow_forward_matches_jax(narrow):
    inputs, variables, model = narrow
    want = BatchedCrowdNet(use_pallas=False, **NARROW).apply(
        variables, *(jnp.asarray(x) for x in inputs))
    with torch.no_grad():
        got = model(*_torch_inputs(inputs))
    assert set(got) == {"density", "flow", "congestion", "count"}
    assert got["density"].shape == (2, 8, 8)
    assert got["flow"].shape == (2, 8, 8, 2)
    assert got["count"].shape == (2,)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


def test_narrow_forward_bf16_matches_jax(narrow):
    inputs, variables, _ = narrow
    want = BatchedCrowdNet(use_pallas=False, dtype=jnp.bfloat16,
                           **NARROW).apply(
        variables, *(jnp.asarray(x) for x in inputs))
    model = CrowdNet(dtype=torch.bfloat16, **NARROW)
    model.load_state_dict(ttrain.params_from_flax(
        _np_tree(variables["params"])))
    with torch.no_grad():
        got = model.eval()(*_torch_inputs(inputs))
    for key in got:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **BF16_TOL)


def test_batch_rows_are_independent(narrow):
    """The batch dimension written out gives each example what it gets
    alone (what ``nn.vmap`` guarantees in the JAX package)."""
    inputs, _, model = narrow
    with torch.no_grad():
        both = model(*_torch_inputs(inputs))
        alone = model(*(x[1:] for x in _torch_inputs(inputs)))
    for key in both:
        np.testing.assert_allclose(both[key][1:].numpy(), alone[key].numpy(),
                                   err_msg=key, rtol=1e-6, atol=1e-6)


def test_shipped_checkpoint_forward_matches_jax():
    params, jcfg = jtrain.load_params_npz(jneural.default_checkpoint_path())
    tree, tcfg = ttrain.load_params_npz(tneural.default_checkpoint_path())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jl = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_leaves_with_path(params)}
    tl = {"".join(f"[{n!r}]" for n in p): v
          for p, v in ttrain.flax_leaves(tree).items()}
    assert set(jl) == set(tl)
    assert all(np.array_equal(jl[k], tl[k]) for k in jl)

    pts = sample_venue(n_points=jcfg.n_points, n_people=20, seed=1)
    pts = pts.astype(np.float32)[None]
    mask = np.ones((1, jcfg.n_points), bool)
    vmin = pts[0, :, :2].min(axis=0)[None]
    vsize = np.float32([np.ptp(pts[0, :, :2], axis=0).max() + 1e-6])
    want = jtrain.make_model(jcfg).apply(
        {"params": params}, jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(vmin), jnp.asarray(vsize))
    model = ttrain.make_model(tcfg)
    model.load_state_dict(ttrain.params_from_flax(tree))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(pts), torch.from_numpy(mask),
                           torch.from_numpy(vmin), torch.from_numpy(vsize))
    assert got["density"].shape == (1, 32, 32)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


def test_train_config_copy_equals_jax():
    assert (dataclasses.asdict(ttrain.TrainConfig())
            == dataclasses.asdict(jtrain.TrainConfig()))
    model = ttrain.make_model(ttrain.TrainConfig())
    assert (model.sa1.n_samples, model.sa2.n_samples, model.grid) == (
        1024, 256, 64)
    assert ttrain.make_model(ttrain.TrainConfig(bf16=True)).sa1.dtype == \
        torch.bfloat16
