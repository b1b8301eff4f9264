"""The port's own copies of the JAX package's jax-free host modules
(``config``, ``synthetic``, ``utils/recommendations``, ``native/loader.cpp``)
against the originals, and the rule that the port imports nothing of the
JAX package.

Everything here is exact: configurations equal field for field, venues
bit-equal, recommendation dicts equal.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from lidar_ai_recommendation_software_tpu import config as jax_config
from lidar_ai_recommendation_software_tpu import synthetic as jax_synthetic
from lidar_ai_recommendation_software_tpu.utils import (
    recommendations as jax_rec)
from lidar_ai_recommendation_software_tpu_torch import config as port_config
from lidar_ai_recommendation_software_tpu_torch import (
    synthetic as port_synthetic)
from lidar_ai_recommendation_software_tpu_torch.utils import (
    recommendations as port_rec)
from port_helpers import imported_modules, port_cfg

REPO = Path(__file__).resolve().parents[1]
PORT = "lidar_ai_recommendation_software_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
             "lidar_ai_recommendation_software_tpu")
NEURAL_MODULES = ("neural.py", "models/crowdnet.py", "models/train.py",
                  "ops/sampling.py", "ops/grouping.py", "ops/hashgrid.py",
                  "ops/cuda/place.py", "ops/cuda/pointnet.py")
# the front-ends and host utilities, at the JAX package's paths
HOST_MODULES = ("cli.py", "compat.py", "app.py", "desktop.py",
                "utils/io.py", "utils/native.py", "utils/store.py",
                "utils/viz.py", "utils/report.py", "utils/profiling.py",
                "utils/resilience.py", "utils/project.py")
# the sharded analytics and training over torch.distributed
PARALLEL_MODULES = ("parallel/mesh.py", "parallel/spatial.py",
                    "parallel/cluster.py", "parallel/trainer.py")
# the CPU oracle, on NumPy and SciPy (the card's machine has no sklearn)
ORACLE_MODULES = ("oracle/reference.py",)


@pytest.mark.parametrize("name", ["MONOLITH_CONFIG", "MODULAR_CONFIG"])
def test_config_copy_equals_jax(name):
    port, jax = getattr(port_config, name), getattr(jax_config, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert dataclasses.asdict(port_cfg(jax)) == dataclasses.asdict(jax)
    assert port_cfg(jax) == port


def test_port_cfg_mirrors_with_capacity():
    jcfg = jax_config.MONOLITH_CONFIG.with_capacity(
        cluster_column_cap=32, density_bucket_cap=8, max_people=4096)
    got = port_cfg(jcfg)
    assert isinstance(got, port_config.PipelineConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    assert got == port_config.MONOLITH_CONFIG.with_capacity(
        cluster_column_cap=32, density_bucket_cap=8, max_people=4096)
    hash(got)  # frozen, as the original


def test_sample_venue_bit_equal():
    np.testing.assert_array_equal(port_synthetic.sample_venue(),
                                  jax_synthetic.sample_venue())


def test_scaled_venue_bit_equal(monkeypatch):
    monkeypatch.setenv("LIDAR_VENUE_CACHE", "")
    np.testing.assert_array_equal(port_synthetic.scaled_venue(50_000),
                                  jax_synthetic.scaled_venue(50_000))


def _stressed_results():
    """Result dicts that fire every rule: a critical and a high hotspot, a
    dense venue, critical and significant bottlenecks, slow flow."""
    density = {"total_people": 900, "avg_density": 3.1, "max_density": 4.5,
               "hotspots": [{"x": 1.0, "y": 2.0, "density": 4.5},
                            {"x": -3.0, "y": 0.5, "density": 2.2}]}
    flow = {"avg_speed": 0.3, "dominant_direction": "SW",
            "bottlenecks": [{"x": 0.0, "y": 0.0, "severity": 9},
                            {"x": 4.0, "y": -2.0, "severity": 5}]}
    return density, flow


@pytest.mark.parametrize("source", ["oracle_monolith", "oracle_modular",
                                    "stressed"])
def test_recommendations_copy_equals_jax(request, source):
    if source == "stressed":
        density, flow = _stressed_results()
    else:
        out = request.getfixturevalue(source)
        density, flow = out["density"], out["flow"]
    got = port_rec.generate_recommendations(
        density, flow, port_config.RecommendationConfig())
    want = jax_rec.generate_recommendations(
        density, flow, jax_config.RecommendationConfig())
    assert got == want
    if source == "stressed":
        assert got["issues"] and got["actions"]


def test_port_package_imports_nothing_of_jax():
    """Every module of the port, read with ``ast``: no import of the JAX
    package, jax, jaxlib, flax, optax, orbax or sklearn, at any depth
    (function bodies too); the modules of the neural path, the
    front-ends, ``parallel/`` and the oracle are among them."""
    files = sorted((REPO / PORT).rglob("*.py"))
    assert len(files) > 10
    for rel in (NEURAL_MODULES + HOST_MODULES + PARALLEL_MODULES
                + ORACLE_MODULES):
        assert REPO / PORT / rel in files, rel
    for path in files:
        bad = [n for n in imported_modules(path)
               if n.split(".")[0] in FORBIDDEN]
        assert not bad, (path, bad)


def test_native_loader_is_a_byte_identical_copy():
    """The port builds the JAX package's C++ parser from its own copy."""
    port = REPO / PORT / "native" / "loader.cpp"
    jax = REPO / "lidar_ai_recommendation_software_tpu" / "native" \
        / "loader.cpp"
    assert port.read_bytes() == jax.read_bytes()
