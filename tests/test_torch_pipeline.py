"""The PyTorch port's Pipeline.analyze end to end, on the CPU, against the
JAX package's Pipeline and the CPU oracle on the seed-42 fixture.

Tolerances: people counts, density grids, hotspots, bottleneck cells and
severities exact; average density within 1e-5 of the oracle (as
tests/test_pipeline.py holds the JAX package); flow vectors, magnitudes
and speeds within 1e-5 of the JAX package's (sin/cos ulps) and 5e-5 of the
oracle's (as tests/test_pipeline.py).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.config import (
    MODULAR_CONFIG, MONOLITH_CONFIG)
from lidar_ai_recommendation_software_tpu.pipeline import Pipeline as JaxPipe
from lidar_ai_recommendation_software_tpu_torch.ops import clustering as tcl
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.types import PointCloud
from port_helpers import imported_modules, port_cfg

CONFIGS = {"monolith": MONOLITH_CONFIG, "modular": MODULAR_CONFIG}
FLOW_TOL = 1e-5
REPO = Path(__file__).resolve().parents[1]
PORT = "lidar_ai_recommendation_software_tpu_torch"


@pytest.fixture(scope="module")
def outputs(fixture_points):
    return {name: (JaxPipe(cfg).analyze(fixture_points),
                   Pipeline(port_cfg(cfg), device="cpu").analyze(
                       fixture_points))
            for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("variant", sorted(CONFIGS))
def test_matches_jax_pipeline(outputs, variant):
    want, got = outputs[variant]
    wd, gd = want["density"], got["density"]
    for key in ("total_people", "avg_density", "max_density", "origin",
                "hotspots"):
        assert gd[key] == wd[key], key
    np.testing.assert_array_equal(gd["density_grid"], wd["density_grid"])
    np.testing.assert_array_equal(got["processed"].labels.numpy(),
                                  np.asarray(want["processed"].labels))
    wf, gf = want["flow"], got["flow"]
    assert gf["dominant_direction"] == wf["dominant_direction"]
    assert gf["bottlenecks"] == wf["bottlenecks"]
    assert abs(gf["avg_speed"] - wf["avg_speed"]) < FLOW_TOL
    for key in ("positions", "vectors", "magnitudes"):
        np.testing.assert_allclose(gf["flow_vectors"][key],
                                   wf["flow_vectors"][key], atol=FLOW_TOL)
    assert got["recommendations"] == want["recommendations"]


def test_monolith_golden_and_oracle(outputs, oracle_monolith):
    out = outputs["monolith"][1]
    d, od = out["density"], oracle_monolith["density"]
    assert d["total_people"] == od["total_people"] == 446
    assert abs(d["avg_density"] - od["avg_density"]) < 1e-5
    assert abs(d["avg_density"] - 0.4958) < 1e-4
    assert d["max_density"] == od["max_density"] == 3.5
    assert np.abs(d["density_grid"] - od["density_grid"]).max() == 0.0
    assert len(d["hotspots"]) == len(od["hotspots"]) == 5
    for a, b in zip(d["hotspots"], od["hotspots"]):
        assert abs(a["x"] - b["x"]) < 1e-4 and abs(a["y"] - b["y"]) < 1e-4
        assert abs(a["density"] - b["density"]) < 1e-6
    f, of = out["flow"], oracle_monolith["flow"]
    assert abs(f["avg_speed"] - of["avg_speed"]) < 1e-5
    assert abs(f["avg_speed"] - 1.2617) < 1e-4
    assert f["dominant_direction"] == of["dominant_direction"] == "E"
    assert [b["severity"] for b in f["bottlenecks"]] == \
        [b["severity"] for b in of["bottlenecks"]] == [8, 8, 8, 7, 7]
    for key, tol in (("positions", 1e-4), ("vectors", 5e-5),
                     ("magnitudes", 5e-5)):
        np.testing.assert_allclose(f["flow_vectors"][key],
                                   of["flow_vectors"][key], atol=tol)


def test_modular_oracle(outputs, oracle_modular):
    out = outputs["modular"][1]
    d, od = out["density"], oracle_modular["density"]
    assert d["total_people"] == od["total_people"]
    assert np.abs(d["density_map"] - od["density_map"]).mean() < 0.01
    assert abs(d["max_density"] - od["max_density"]) < 1e-6
    f, of = out["flow"], oracle_modular["flow"]
    assert abs(f["avg_speed"] - of["avg_speed"]) < 1e-5
    assert f["dominant_direction"] == of["dominant_direction"]
    assert [b["severity"] for b in f["bottlenecks"]] == \
        [b["severity"] for b in of["bottlenecks"]]


def _ground(n, seed, sigma=0.01):
    rng = np.random.RandomState(seed)
    return np.column_stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                            rng.normal(0, sigma, n)]).astype(np.float32)


@pytest.mark.parametrize("name,points", [
    ("empty_scene", _ground(2000, 0)),
    ("small_cloud", np.random.RandomState(1).uniform(
        -1, 1, (50, 3)).astype(np.float32)),
    ("flat_cloud", _ground(3000, 2, sigma=0.0)),
    ("seven_points", np.random.RandomState(3).uniform(
        -1, 1, (7, 3)).astype(np.float32)),
])
def test_edge_cases_match_jax(name, points):
    got = Pipeline(device="cpu").analyze(points)
    want = JaxPipe().analyze(points)
    assert got["density"]["total_people"] == want["density"]["total_people"]
    assert got["flow"]["dominant_direction"] == \
        want["flow"]["dominant_direction"]
    assert got["flow"]["bottlenecks"] == want["flow"]["bottlenecks"]
    np.testing.assert_array_equal(got["density"]["density_grid"],
                                  want["density"]["density_grid"])


@pytest.mark.parametrize("offset", [1e5, -1e5])
def test_utm_offset_recentres(fixture_points, offset):
    shifted = fixture_points + np.array([offset, offset, 0.0])
    out = Pipeline(device="cpu").analyze(shifted)
    assert out["density"]["total_people"] == 446
    assert out["coordinate_offset"][0] != 0.0
    hx = out["density"]["hotspots"][0]["x"]
    assert abs(hx - offset - 5.5) < 0.1


def _dense_venue():
    """256 points: 77 ground + 35 tight blobs of 5+ points; fit_capacity
    gives max_people = 32 < 35 (as in tests/test_pipeline.py)."""
    rng = np.random.RandomState(7)
    ground = np.column_stack([rng.uniform(-10, 10, 77),
                              rng.uniform(-10, 10, 77), np.zeros(77)])
    blobs = []
    for k in range(35):
        cx, cy = -10 + 3.0 * (k % 7), -10 + 3.0 * (k // 7)
        m = 9 if k == 0 else 5
        blobs.append(np.column_stack([cx + rng.uniform(-0.05, 0.05, m),
                                      cy + rng.uniform(-0.05, 0.05, m),
                                      np.full(m, 1.5)]))
    return np.concatenate([ground] + blobs).astype(np.float32)


def test_people_capacity_overflow_flagged():
    pts = _dense_venue()
    pipe = Pipeline(port_cfg(MONOLITH_CONFIG.with_capacity(max_people=4)),
                    device="cpu")
    cfg = pipe.fit_capacity(pts.astype(np.float64))
    assert cfg.capacity.max_people == 32
    cloud = PointCloud.from_numpy(pts, cfg.capacity.max_points)
    _, people, _ = pipe.analyze_device(cloud, cfg)
    assert int(people.overflow) == 3
    assert int(people.count) == 32


def test_people_capacity_retry():
    out = Pipeline(port_cfg(MONOLITH_CONFIG.with_capacity(max_people=4)),
                   device="cpu").analyze(_dense_venue())
    assert out["density"]["total_people"] == 35
    assert int(out["people"].overflow) == 0


def test_cloud_above_slice_raises(monkeypatch):
    """Past the modular variant's all-pairs ceiling (shrunk here from
    131,072 to 1,024 points, as tests/test_clustering.py shrinks the JAX
    package's) the pipeline refuses with an error rather than return a
    census that dropped points. The monolith variant has no such ceiling
    below the column table's memory (tests/test_torch_venue.py)."""
    monkeypatch.setattr(tcl, "BRUTEFORCE_HARD_CAP", 1024)
    rng = np.random.RandomState(9)
    centers = rng.uniform(-60, 60, (12, 2))
    pts = np.zeros((6000, 3))
    pts[:4800, :2] = centers[rng.randint(0, 12, 4800)] + rng.normal(
        0, 0.35, (4800, 2))
    pts[4800:, :2] = rng.uniform(-60, 60, (1200, 2))
    pts[:, 2] = rng.uniform(0, 0.5, 6000)
    pipe = Pipeline(port_cfg(MODULAR_CONFIG.with_capacity(
        cluster_column_cap=512)), device="cpu")
    with pytest.raises(RuntimeError, match="brute force"):
        pipe.analyze(pts)


def test_device_is_explicit():
    if torch.cuda.is_available():
        assert Pipeline().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Pipeline()
    assert Pipeline(device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    """In a fresh process, the port's pipeline, its CUDA wrapper modules
    and every module chip_smoke.py imports load without jax, jaxlib,
    flax or any module of the JAX package."""
    mods = sorted(n for n in imported_modules(REPO / "chip_smoke.py")
                  if n.startswith(PORT))
    mods += sorted(n for n in imported_modules(
        REPO / "tools" / "profile_torch_port.py") if n.startswith(PORT))
    mods += [f"{PORT}.pipeline", f"{PORT}.neural", f"{PORT}.models.crowdnet",
             f"{PORT}.models.train", f"{PORT}.ops.sampling",
             f"{PORT}.ops.grouping", f"{PORT}.ops.cuda.kernels",
             f"{PORT}.ops.cuda.columns", f"{PORT}.ops.cuda.place",
             f"{PORT}.ops.cuda.pointnet"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', "
            "'lidar_ai_recommendation_software_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=REPO)


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/profile_torch_port.py"])
def test_gpu_scripts_import_only_the_port(script):
    """The scripts that run on the card import the port and nothing of
    the JAX package."""
    names = imported_modules(REPO / script)
    assert any(n.startswith(PORT) for n in names), names
    bad = [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax",
        "lidar_ai_recommendation_software_tpu")]
    assert not bad, bad
    # both drive the neural path and the centroid route, not only Pipeline
    text = (REPO / script).read_text()
    for needed in ("NeuralPipeline", "sa_mlp_pool", "fps_single",
                   "3_000_000"):
        assert needed in text, (script, needed)

