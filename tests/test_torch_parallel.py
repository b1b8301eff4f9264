"""The port's ``parallel/`` against the JAX package's, on the CPU: four
ranks over gloo, started once by the port's launcher
(``parallel.mesh.spawn``), run every case (``torch_parallel_worker.py``)
and write their results; the JAX package's functions run here on a mesh
of the first 4 of conftest's 8 virtual devices, while the ranks work.

Tolerances: the stripe partition, the boundary maps and DBSCAN labels
exact; the density within 1e-6 (``tests/test_parallel.py``); the flow's
speeds within 1e-5, its valid nodes, bottleneck flags and the severities
on them exact; the dp 2 x mp 2 step's loss within 1e-4 of the JAX
package's ``train_step`` from the same weights (``test_parallel.py``);
against the port's single-process ``train_step``, the first loss within
1e-6 relative and the later ones within 1e-4, every first-step gradient
within 1e-5 relative (norm of the difference over the norm: the dp
shards' sums in another order, as ``tests/test_torch_train.py``); each
step's updated parameters within 1e-6 relative plus 1e-4 x lr of the
single-process AdamW update of the same reduced gradients from the same
parameters (``tests/test_torch_train.py``'s bound on one update: the same
formula rounded in another order). Three steps, so the second and third
updates hold each rank's sliced moments to the whole ones.
"""

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from lidar_ai_recommendation_software_tpu.config import MONOLITH_CONFIG
from lidar_ai_recommendation_software_tpu.models import train as jtrain
from lidar_ai_recommendation_software_tpu.parallel import cluster as jcluster
from lidar_ai_recommendation_software_tpu.parallel import spatial as jspatial
from lidar_ai_recommendation_software_tpu.parallel import (
    trainer as jtrainer)
from lidar_ai_recommendation_software_tpu.parallel.mesh import make_mesh
from lidar_ai_recommendation_software_tpu.pipeline import (
    Pipeline as JPipeline)
from lidar_ai_recommendation_software_tpu_torch.models import flow as tflow
from lidar_ai_recommendation_software_tpu_torch.models import train as ttrain
from lidar_ai_recommendation_software_tpu_torch.ops import ccl
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.parallel import cluster
from lidar_ai_recommendation_software_tpu_torch.parallel import mesh as pmesh
from lidar_ai_recommendation_software_tpu_torch.parallel import trainer
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    scaled_venue)
from lidar_ai_recommendation_software_tpu_torch.types import PointCloud

import torch_parallel_worker as worker
from port_helpers import port_cfg

TINY = dict(batch_size=4, n_points=256, grid=8, sa1_samples=64,
            sa2_samples=16)
RANKS = 4
GRAD_TOL = 1e-5


def _jmesh(axes):
    return make_mesh(axes, devices=jax.devices()[:RANKS])


def _venue(seed=3, n=1200):
    """``tests/test_parallel.py``'s venue: 30 crowds of points."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-14, 14, (30, 2))
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = centers[rng.randint(0, 30, n)] + rng.normal(0, 0.15, (n, 2))
    pts[:, 2] = rng.uniform(0, 1.8, n)
    return pts


def _rope(n=400):
    """One rope of points across every stripe boundary, 0.08 m apart."""
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = np.linspace(-16, 16, n)
    pts[:, 1] = 0.05 * np.sin(np.arange(n))
    return pts


def _rounding_case():
    """A radius whose two float32 squares differ (float32(r) squared in
    float32, the JAX shard's; r^2 rounded once from float64, the kernel's
    default), and a person on the centre of cell (0, 0) of an 8 x 4 grid
    at origin (-0.5, -0.5) whose squared distance is the larger of the
    two: counted under one rounding, not under the other."""
    for r in np.round(np.arange(0.1, 2.0, 0.01), 2):
        jax_r2 = np.float32(r) * np.float32(r)
        big = max(jax_r2, np.float32(float(r) * float(r)))
        if jax_r2 == np.float32(float(r) * float(r)):
            continue
        dx = np.float32(np.sqrt(np.float64(big)))
        for _ in range(8):
            dx = np.nextafter(dx, np.float32(0))
        for _ in range(16):
            if dx * dx == big:
                people = np.zeros((4, 2), np.float32)
                people[0, 0] = dx
                return float(r), {
                    "people": people, "people_mask": np.arange(4) == 0,
                    "origin": np.float32([-0.5, -0.5]), "nx": 8, "ny": 4}
            dx = np.nextafter(dx, np.float32(1))
    raise AssertionError("no radius with a person between the roundings")


def _rounding_cfg(radius):
    return dataclasses.replace(
        MONOLITH_CONFIG, capacity=dataclasses.replace(
            MONOLITH_CONFIG.capacity, grid_cells_x=8, grid_cells_y=4),
        density=dataclasses.replace(MONOLITH_CONFIG.density, radius=radius))


def _jax_references(inp, jcfg, radius):
    """The JAX package's sharded functions on ``inp``, each a function
    of no argument (they run in threads: XLA compiles without the
    interpreter lock, and each call here compiles anew)."""
    sp = _jmesh((("sp", RANKS),))

    def density(d, cfg):
        return lambda: np.asarray(jspatial.sharded_radius_density(
            jnp.asarray(d["people"]), jnp.asarray(d["people_mask"]),
            jnp.asarray(d["origin"]), jnp.asarray(d["nx"]),
            jnp.asarray(d["ny"]), cfg, sp))

    def flow():
        return [np.asarray(v) for v in jspatial.sharded_flow_and_bottlenecks(
            jnp.asarray(inp["mins"]), jnp.asarray(inp["maxs"]),
            jnp.asarray(inp["uniforms"]), jcfg, sp)]

    def halo():
        return np.asarray(jax.shard_map(
            lambda local: jspatial.halo_exchange_x(local, 2, "sp"),
            mesh=sp, in_specs=P("sp"), out_specs=P("sp"))(
                jnp.arange(32.0).reshape(32, 1))).reshape(RANKS, 12, 1)

    return {
        "density": density(inp, jcfg),
        "density_rounding": density(inp["rounding"], _rounding_cfg(radius)),
        "flow": flow, "halo": halo,
        # a cap the venue does not overflow: one compile, not four
        "venue": lambda: jcluster.sharded_dbscan(inp["venue"], 0.4, 5, sp,
                                                 column_cap=64),
        "rope": lambda: jcluster.sharded_dbscan(inp["rope"], 0.3, 3, sp)}


@pytest.fixture(scope="module")
def run(fixture_points, tmp_path_factory):
    """The inputs; the ranks' results (rank r -> its npz) and the JAX
    package's, computed here while the ranks run."""
    jcfg = JPipeline(MONOLITH_CONFIG).fit_capacity(fixture_points)
    cfg = port_cfg(jcfg)
    pipe = Pipeline(cfg, device="cpu")
    cloud = PointCloud.from_numpy(fixture_points, cfg.capacity.max_points,
                                  device="cpu")
    processed, people, res = pipe.analyze_device(cloud, cfg)
    radius, rounding = _rounding_case()
    tcfg = ttrain.TrainConfig(**TINY)
    batch = ttrain.make_batch(np.random.RandomState(0), tcfg)
    inp = {
        "cfg": cfg, "people": people.positions.numpy(),
        "people_mask": people.mask.numpy(),
        "origin": processed.mins[:2].numpy(), "nx": int(res.density.nx),
        "ny": int(res.density.ny), "mins": processed.mins[:2].numpy(),
        "maxs": processed.maxs[:2].numpy(),
        "uniforms": tflow.bottleneck_uniforms().astype(np.float32),
        "rounding": rounding,
        "rounding_cfg": port_cfg(_rounding_cfg(radius)),
        "venue": _venue(), "rope": _rope(),
        "venue_200k": scaled_venue(200_000).astype(np.float32),
        "train_cfg": tcfg, "batch": batch}
    outdir = str(tmp_path_factory.mktemp("ranks"))
    with ThreadPoolExecutor(8) as pool:
        refs = {k: pool.submit(f) for k, f in
                _jax_references(inp, jcfg, radius).items()}
        jstate = jtrain.init_state(jtrain.TrainConfig(**TINY))
        jparams = jax.tree_util.tree_map(np.asarray, jstate.params)
        params = {k: v.numpy()
                  for k, v in ttrain.params_from_flax(jparams).items()}
        ranks = pool.submit(pmesh.spawn, worker.run_cases, RANKS, outdir,
                            dict(inp, params=params))
        _, metrics = jtrain.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jtrain.TrainConfig(**TINY))
        ranks.result(timeout=600)
        jax_out = {k: f.result() for k, f in refs.items()}
    jax_out["loss"] = float(metrics["loss"])
    for name, v in zip(("vectors", "mags", "valid", "sev", "ok"),
                       jax_out.pop("flow")):
        jax_out[f"flow_{name}"] = v
    got = [dict(np.load(f"{outdir}/rank{r}.npz")) for r in range(RANKS)]
    return dict(inp=inp, jax=jax_out, got=got, res=res, processed=processed,
                cfg=cfg, radius=radius, params=params, jparams=jparams)


def test_rank_processes_import_nothing_of_jax(run):
    for r, got in enumerate(run["got"]):
        assert got["jax_modules"].size == 0, (r, got["jax_modules"])
        assert int(got["sp_coord"]) == r
        assert got["train_mesh"].tolist() == [2, 2]
    assert "jax" in sys.modules  # while this process has it


@pytest.mark.parametrize("case", ["venue", "rope", "venue_200k"])
def test_partition_and_boundary_maps_equal_jax(case, run):
    pts = run["inp"][case]
    eps = 0.4 if case == "venue" else 0.3
    got = cluster.partition_stripes(pts, RANKS, eps)
    want = jcluster.partition_stripes(pts, RANKS, eps)
    for a, b in zip(got + cluster.boundary_maps(pts, RANKS, eps, got[3]),
                    want + jcluster.boundary_maps(pts, RANKS, eps, want[3])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_halo_round_trip(run):
    for got in run["got"]:
        np.testing.assert_array_equal(got["halo"], run["jax"]["halo"])
    halo = run["got"][0]["halo"][:, :, 0]
    np.testing.assert_array_equal(halo[1], [6, 7, *range(8, 16), 16, 17])
    assert (halo[0, :2] == 0).all() and (halo[3, -2:] == 0).all()


def test_sharded_density_matches_jax(run):
    got = run["got"][0]["density"]
    np.testing.assert_allclose(got, run["jax"]["density"], atol=1e-6)
    np.testing.assert_allclose(
        got, run["res"].density.density_grid.numpy(), atol=1e-6)
    assert got.max() > 0
    for other in run["got"][1:]:
        np.testing.assert_array_equal(other["density"], got)


def test_sharded_density_squares_the_radius_as_jax(run):
    """At a radius where float32(r)^2 in float32 and the float64 square
    rounded once differ, the sharded density gives the JAX shard's count,
    and the kernel's default rounding would not."""
    got = run["got"][0]["density_rounding"]
    want = run["jax"]["density_rounding"]
    np.testing.assert_array_equal(got, want)
    r = run["radius"]
    case = run["inp"]["rounding"]
    default = kernels.radius_count_reference(
        torch.zeros((1, 2)), torch.from_numpy(case["people"]),
        torch.from_numpy(case["people_mask"]), r)
    assert got[0, 0] * 4.0 != float(default[0])
    assert got[0, 0] * 4.0 == float(np.float32(r) * np.float32(r)
                                    >= np.float32(float(r) * float(r)))


def test_sharded_flow_matches_jax(run):
    got, want = run["got"][0], run["jax"]
    np.testing.assert_allclose(got["flow_mags"], want["flow_mags"],
                               atol=1e-5)
    np.testing.assert_allclose(got["flow_vectors"], want["flow_vectors"],
                               atol=1e-5)
    for k in ("valid", "ok"):
        np.testing.assert_array_equal(got[f"flow_{k}"], want[f"flow_{k}"])
    ok = got["flow_ok"]
    assert ok.any()
    np.testing.assert_array_equal(got["flow_sev"][ok],
                                  want["flow_sev"][want["flow_ok"]])
    # and the single-device internals of the port
    processed, cfg = run["processed"], run["cfg"]
    u = torch.from_numpy(run["inp"]["uniforms"])
    _, mag1, valid1, _, _ = tflow.synthesize_flow(processed, u, cfg)
    sev1, ok1 = tflow._bottlenecks_monolith(mag1, valid1, cfg)
    np.testing.assert_allclose(got["flow_mags"], mag1.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got["flow_ok"], ok1.numpy())
    np.testing.assert_array_equal(got["flow_sev"][ok], sev1.numpy()[ok])


@pytest.mark.parametrize("case", ["venue", "venue_cap64", "rope"])
def test_sharded_dbscan_labels_equal_jax(case, run):
    """The port's labels on every rank are JAX's ``sharded_dbscan``'s,
    the venue's also from a cap it overflows (every rank retries)."""
    want = run["jax"]["rope" if case == "rope" else "venue"]
    for got in run["got"]:
        np.testing.assert_array_equal(got[case], want)
    if case == "rope":
        assert len(np.unique(want)) == 1 and (want >= 0).all()
    else:
        assert (want >= 0).sum() > 1000 and len(np.unique(want)) > 20


def test_sharded_dbscan_at_200k_equals_single_process(run):
    """BASELINE config 5 at test scale: the 200,000-point venue sharded 4
    ways gives the port's single-process ``dbscan_gs`` labels once the
    representatives are compacted."""
    pts = run["inp"]["venue_200k"]
    n = len(pts)
    single, n_clusters, overflow = ccl.dbscan_gs(
        torch.from_numpy(pts), torch.ones(n, dtype=torch.bool), 0.3, 5,
        ncx=512, ncy=512, column_cap=32)
    assert int(overflow) == 0
    lab = run["got"][0]["venue_200k"]
    reps = np.unique(lab[lab >= 0])
    dense = np.full(n + 1, -1, np.int64)
    dense[reps] = np.arange(len(reps))
    np.testing.assert_array_equal(
        np.where(lab >= 0, dense[np.clip(lab, 0, n)], -1), single.numpy())
    assert len(reps) == int(n_clusters) > 10_000


def test_round_budget_raises(run):
    """The rope spans 4 stripes: one round of label agreement leaves
    labels changing, and every rank raises where the JAX package would
    stop silently with wrong labels."""
    for got in run["got"]:
        assert "after 1 rounds" in str(got["round_budget"])
    assert run["got"][0]["exchanges"] > 0


def test_param_spec_chooses_jax_leaves(run):
    shardings = jtrainer.make_param_shardings(
        _jmesh((("dp", 2), ("mp", 2))), run["jparams"])
    want = {tuple(getattr(k, "key", str(k)) for k in path)[1:]: s.spec
            for path, s in jax.tree_util.tree_flatten_with_path(
                shardings)[0]}
    assert len(want) == len(run["params"])
    chosen = 0
    for name, value in run["params"].items():
        dim = trainer.param_spec(name, torch.from_numpy(value), 2)
        path, is_conv = ttrain._flax_path(name)
        spec = tuple(want[path])
        assert (dim is not None) == ("mp" in spec), name
        if dim is not None:
            chosen += 1
            # flax's last axis, the output features
            assert spec[-1] == "mp" and dim == (0 if is_conv
                                                else value.ndim - 1)
    assert chosen == sum("mp" in tuple(s) for s in want.values()) > 10


@pytest.mark.parametrize("mesh", ["dp2mp2", "dp4"])
def test_sharded_step_matches_jax_and_single_process(mesh, run):
    """Three steps from the JAX package's weights: the first loss within
    1e-4 of JAX's ``train_step``; the losses and the first dp-reduced
    gradients against the port's single-process ``train_step``; each
    update against the single-process AdamW update of the step's reduced
    gradients; every rank the same; each mp rank keeping half of a
    sharded leaf."""
    got = run["got"]
    cfg = ttrain.TrainConfig(**TINY)
    params = {k: torch.from_numpy(v) for k, v in run["params"].items()}
    state = ttrain.init_state(cfg, device="cpu")
    state.model.load_state_dict(params)
    batch = ttrain.batch_tensors(run["inp"]["batch"], "cpu")
    losses = [float(got[0][f"{mesh}_loss{t}"])
              for t in range(worker.TRAIN_STEPS)]
    assert abs(losses[0] - run["jax"]["loss"]) < 1e-4
    for t in range(worker.TRAIN_STEPS):
        metrics = ttrain.train_step(state, batch, cfg)
        assert losses[t] == pytest.approx(float(metrics["loss"]),
                                          rel=1e-6 if t == 0 else 1e-4)
        if t == 0:
            for name, p in state.model.named_parameters():
                g = got[0][f"{mesh}_grad0:{name}"]
                want = p.grad.numpy()
                rel = np.linalg.norm(g - want) / np.linalg.norm(want)
                assert rel <= GRAD_TOL, (name, rel)
    replay = ttrain.init_state(cfg, device="cpu")
    replay.model.load_state_dict(params)
    for t in range(worker.TRAIN_STEPS):
        lr = replay.schedule(replay.step)
        for name, p in replay.model.named_parameters():
            p.grad = torch.from_numpy(got[0][f"{mesh}_grad{t}:{name}"])
        ttrain.apply_update(replay)
        for name, p in replay.model.named_parameters():
            np.testing.assert_allclose(got[0][f"{mesh}_param{t}:{name}"],
                                       p.detach().numpy(), rtol=1e-6,
                                       atol=1e-4 * lr,
                                       err_msg=f"step {t}, {name}")
    for other in got[1:]:
        for key in got[0]:
            if key.startswith(mesh):
                np.testing.assert_array_equal(other[key], got[0][key])
    numel = got[0][f"{mesh}_shard_numel"]
    named = list(state.model.named_parameters())
    whole = np.array([p.numel() for _, p in named])
    if mesh == "dp4":
        np.testing.assert_array_equal(numel, whole)
    else:
        sharded = np.array([trainer.param_spec(n, p, 2) is not None
                            for n, p in named])
        np.testing.assert_array_equal(numel, np.where(sharded, whole // 2,
                                                      whole))
        assert sharded.sum() > 10
        assert numel.sum() < 0.6 * whole.sum()


def test_run_sharded_steps_matches_fit(run):
    """Three steps on the train mesh (dp 2 x mp 2) from ``init_state``'s
    draw give the single-process ``fit``'s last metrics within 1e-4
    relative, as ``tests/test_torch_train.py`` holds three steps: the
    last loss reads the parameters of two updates through the sliced
    moments."""
    _, want = ttrain.fit(ttrain.TrainConfig(**TINY), worker.TRAIN_STEPS,
                         log_every=0, device="cpu")
    for got in run["got"]:
        np.testing.assert_allclose(
            got["run_sharded_steps"], [want[k] for k in sorted(want)],
            rtol=1e-4)
