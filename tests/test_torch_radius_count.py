"""The PyTorch port's radius_count against the JAX package's.

On the CPU the port's ``radius_count`` takes its plain version; it is held
bit-equal (int32 counts, tolerance 0) to the JAX Pallas kernel run in
interpret mode, as tests/test_pallas_kernels.py runs it, and to the jnp
reference. The CUDA kernel itself is held against the plain version on
the card by the test marked ``cuda``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.ops.pallas import kernels as K
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels as TK


def _case(seed, c, k, live, span=20.0, scattered=False):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-span / 2, span / 2, (c, 2)).astype(np.float32)
    people = rng.uniform(-span / 2, span / 2, (k, 2)).astype(np.float32)
    if scattered:
        pmask = rng.rand(k) < 0.4
    else:
        pmask = np.arange(k) < live
    return centers, people, pmask


def _boundary_case():
    """People at exactly r (in f32) from cell centre (4.5, 4.5) count; one
    1e-3 beyond does not."""
    r = 2.0
    i, j = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    centers = np.stack([i.ravel() + 0.5, j.ravel() + 0.5], 1)
    c = np.float32([4.5, 4.5])
    people = np.stack([c + [r, 0.0], c + [0.0, -r], c + [r + 1e-3, 0.0], c,
                       c + [-r, 0.0], c + [0.0, r]])
    return (centers.astype(np.float32), people.astype(np.float32),
            np.ones(len(people), bool))


CASES = {
    "random": lambda: _case(0, 700, 300, 250),
    "fixture_shape": lambda: _case(1, 4096, 1280, 446, span=30.0),
    "live_prefix_short": lambda: _case(2, 512, 1000, 37),
    "scattered_mask": lambda: _case(3, 600, 500, 0, scattered=True),
    "no_people": lambda: _case(4, 300, 64, 0),
    "exact_radius": _boundary_case,
}


def _jax_counts(centers, people, pmask, radius):
    got = K.radius_count(jnp.asarray(centers), jnp.asarray(people),
                         jnp.asarray(pmask), radius, tile=256)
    ref = K.radius_count_reference(jnp.asarray(centers),
                                   jnp.asarray(people), jnp.asarray(pmask),
                                   radius)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    return np.asarray(got)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("radius", [2.0, 1.5])
def test_radius_count_matches_jax(name, radius):
    centers, people, pmask = CASES[name]()
    want = _jax_counts(centers, people, pmask, radius)
    tc, tp, tm = (torch.from_numpy(a) for a in (centers, people, pmask))
    got = TK.radius_count(tc, tp, tm, radius)
    assert got.dtype == torch.int32 and got.shape == (len(centers),)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TK.radius_count_reference(tc, tp, tm, radius).numpy(), want)
    if name == "exact_radius" and radius == 2.0:
        assert int(got[4 * 16 + 4]) == 5  # the one at r + 1e-3 is out


def test_radius_squared_rounds_like_the_tpu_kernel():
    """At r = 0.1, float32(r)^2 and float32(r * r) differ by an ulp; a
    person at distance float32(0.1) sits between them. The port squares
    r as the TPU kernel does, so that person is out, as there."""
    r = 0.1
    r32 = np.float32(r)
    assert r32 * r32 > np.float32(r * r)
    centers = np.float32([[0.0, 0.0], [3.0, 3.0]])
    people = np.float32([[r32, 0.0], [0.0, -0.0999], [0.0, -r32]])
    pmask = np.ones(3, bool)
    want = _jax_counts(centers, people, pmask, r)
    np.testing.assert_array_equal(want, [1, 0])
    tc, tp, tm = (torch.from_numpy(a) for a in (centers, people, pmask))
    np.testing.assert_array_equal(TK.radius_count(tc, tp, tm, r).numpy(),
                                  want)
    np.testing.assert_array_equal(
        TK.radius_count_reference(tc, tp, tm, r).numpy(), want)


def test_cpu_tensor_never_builds_the_kernel(monkeypatch):
    """A CPU tensor goes to the plain version without touching the CUDA
    build (which this machine cannot do) or the launch count."""
    def no_build():
        raise AssertionError("CPU path tried to build the CUDA kernel")
    monkeypatch.setattr(TK, "load_library", no_build)
    before = TK.LAUNCHES["radius_count"]
    centers, people, pmask = CASES["random"]()
    TK.radius_count(torch.from_numpy(centers), torch.from_numpy(people),
                    torch.from_numpy(pmask), 2.0)
    assert TK.LAUNCHES["radius_count"] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version_on_card(cuda_device, name):
    centers, people, pmask = CASES[name]()
    tc, tp, tm = (torch.from_numpy(a).to(cuda_device)
                  for a in (centers, people, pmask))
    before = TK.LAUNCHES["radius_count"]
    got = TK.radius_count(tc, tp, tm, 2.0)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["radius_count"] == before + 1
    want = TK.radius_count_reference(tc, tp, tm, 2.0)
    assert torch.equal(got, want)
