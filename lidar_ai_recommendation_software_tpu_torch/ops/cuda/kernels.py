"""Hand-written CUDA kernels for Hopper (sm_90a), their loader, and the
``radius_count`` kernel's launch plan, wrapper and plain PyTorch version.

The counterpart of the JAX package's ``ops/pallas/kernels.py``. Beside this
module, ``columns.py`` wraps the column-table kernels of the venue-scale
clustering, ``eps.py`` the eps-adjacency of the all-pairs clustering,
``place.py`` the ``place_dense`` scatter of the centroid pack, and
``pointnet.py`` farthest-point sampling and the fused set-abstraction
MLP of the neural path. Each kernel has a wrapper that
dispatches on the device of its tensors: a CPU tensor goes to the plain
version; a CUDA tensor goes to the kernel, and a kernel that fails to
build or launch raises. The plain versions are what the CPU tests run and
what the kernels are compared with on the card.

Build: at first use every source under ``csrc/`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, in ``_build/`` inside the
package, under a name keyed on a hash of the sources and the flags (an
edited source rebuilds); the library is loaded with ``ctypes``.

Every wrapper adds one to its entry of ``LAUNCHES`` where it launches its
kernel, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.utils.profiling import stage

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC")

LAUNCHES = {"radius_count": 0, "table_fill": 0, "dense_tail": 0,
            "column_counts": 0, "border_min": 0, "propagate": 0,
            "place_dense": 0, "fps_single": 0, "fps_batched": 0,
            "sa_mlp_pool": 0, "eps_edges": 0}
# fps launches by the route of its launch plan (ops/cuda/pointnet.py)
FPS_ROUTES = {"registers": 0, "block": 0, "cluster": 0, "stream": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each launch function in csrc/ (pointers and the stream
# as c_void_p: a bare Python int would be cut to 32 bits)
_SIGNATURES = {
    "radius_count_launch": [_P, _P, _P, _F] + [_I] * 5 + [_P, _P],
    "table_fill_launch": [_P, _P, _P] + [_I] * 4 + [_P] * 5,
    "dense_tail_launch": [_P, _P] + [_I] * 3 + [_P, _P, _P, _P],
    "column_counts_launch": [_P, _P] + [_I] * 4 + [_F, _P, _P, _P],
    "border_min_launch": [_P, _P] + [_I] * 4 + [_F, _P, _P, _P],
    "propagate_launch": [_P, _P, _I, _I, _I, _F, _P, _P, _P],
    "place_dense_launch": [_P, _P, _P, _I, _I, _I, _P, _P],
    "fps_max_active_clusters": [_I, _I, _I],
    "fps_launch": [_P, _P, _P] + [_I] * 9 + [_P, _P],
    "sa_mlp_pool_launch": [_P] * 8 + [_I] * 7 + [_P, _P],
    "eps_count_launch": [_P, _P, _I, _F] + [_I] * 4 + [_P, _P],
    "eps_fill_launch": [_P, _P, _I, _F] + [_I] * 4 + [_P] * 4,
}

# the most shared memory a block of sm_90 may use
SMEM_PER_BLOCK = 232_448

# Pair tests per chunk of the plain all-pairs passes, here and in
# ``eps.py`` (bounds their temporaries at a few hundred MB).
PAIRS_PER_CHUNK = 1 << 24


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FPS_ROUTES):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    """Where the shared library of the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile every source with its own nvcc, all at once, then link.
    The compilers' reports (registers, shared memory, spills) are kept
    beside the library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        reports.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = so.with_name(f"{tag}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        so.with_suffix(".log").write_text("\n".join(reports))
        os.replace(tmp, so)  # atomic: a concurrent build never sees half
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, in a
    ``setup.kernels`` span whose ``built`` says whether nvcc ran."""
    with stage("setup.kernels") as attrs:
        so = library_path()
        attrs["built"] = not so.exists()
        if attrs["built"]:
            _build(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    """The card's multiprocessors, for the persistent grids."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for {t.device}")
    return t.device


def _radius_sq(radius: float) -> np.float32:
    """r^2 squared in float64 and rounded once to float32, as the JAX
    package's ``radius_count`` kernel rounds it. (Its jnp density path
    squares float32(r) instead; the two agree wherever r^2 is exact in
    float32, as at the configured radius of 2 m, and differ by an ulp at
    radii such as 0.1.)"""
    return np.float32(float(radius) * float(radius))


# ---------------------------------------------------------------------------
# radius_count
# ---------------------------------------------------------------------------

def radius_count_reference(centers: torch.Tensor, people: torch.Tensor,
                           pmask: torch.Tensor, radius: float,
                           r2: Optional[np.float32] = None) -> torch.Tensor:
    """Plain PyTorch version: (C,) int32 count of valid people within
    ``radius`` (inclusive) of each centre, chunked over centres so no
    (C, K) tensor is built at once."""
    c, k = centers.shape[0], people.shape[0]
    r2 = torch.tensor(_radius_sq(radius) if r2 is None else r2,
                      dtype=centers.dtype, device=centers.device)
    chunk = max(1, PAIRS_PER_CHUNK // max(k, 1))
    out = [torch.zeros(0, dtype=torch.int32, device=centers.device)]
    for s in range(0, c, chunk):
        q = centers[s:s + chunk]
        dx = q[:, None, 0] - people[None, :, 0]
        dy = q[:, None, 1] - people[None, :, 1]
        d2 = dx * dx + dy * dy
        out.append(((d2 <= r2) & pmask[None, :]).sum(1, dtype=torch.int32))
    return torch.cat(out)


# The layout of csrc/radius_count.cu, which the plan mirrors (the kernel's
# entry point refuses a grid that does not cover its inputs):
RADIUS_THREADS = 128
RADIUS_PER_THREAD = 4            # centres a thread holds
RADIUS_PEOPLE_TILE = 128         # people staged a tile, one a thread
RADIUS_CENTRE_TILE = RADIUS_THREADS * RADIUS_PER_THREAD
# blocks the plan aims at: slices of one people tile while the grid stays
# under it, so that the 132 SMs find live work at the sensor frame's shape;
# above it, longer slices
RADIUS_TARGET_BLOCKS = 4096


@dataclasses.dataclass(frozen=True)
class RadiusPlan:
    """How ``csrc/radius_count.cu`` covers C centres x K people: block
    (x, y) counts centres [x * RADIUS_CENTRE_TILE, (x + 1) *
    RADIUS_CENTRE_TILE) against people tiles [y * tiles_per_slice, (y + 1) *
    tiles_per_slice) of RADIUS_PEOPLE_TILE people each, both cut at C and
    K."""

    tiles_per_slice: int
    grid: tuple


def radius_plan(c: int, k: int) -> RadiusPlan:
    """The launch plan for ``c`` centres and ``k`` people, by the shapes
    alone (the live people are counted nowhere): one block per centre tile
    and slice, the slices one people tile long unless that makes more than
    ``RADIUS_TARGET_BLOCKS`` blocks. No people (or no centres): a grid with
    no block, and the kernel only zeroes the output."""
    centre_tiles = -(-c // RADIUS_CENTRE_TILE)
    people_tiles = -(-k // RADIUS_PEOPLE_TILE)
    per_slice = max(1, -(-centre_tiles * people_tiles
                         // RADIUS_TARGET_BLOCKS))
    return RadiusPlan(per_slice, (centre_tiles, -(-people_tiles // per_slice)))


def radius_count(centers: torch.Tensor, people: torch.Tensor,
                 pmask: torch.Tensor, radius: float,
                 r2: Optional[np.float32] = None) -> torch.Tensor:
    """Count valid people within ``radius`` (inclusive) of each centre:
    squared distances at most ``r2``, by default radius^2 rounded once
    from float64 (``_radius_sq``, the JAX package's kernel); the sharded
    density hands over float32(radius) squared in float32, as its JAX
    counterpart squares it.

    centers (C, 2) float32, people (K, 2) float32, pmask (K,) bool ->
    (C,) int32. CPU tensors take the plain version; CUDA tensors take the
    kernel in ``csrc/radius_count.cu`` by ``radius_plan(C, K)``: one
    allocation and one launch function (a zeroing of the output and the
    kernel), no read of the device."""
    if centers.device.type == "cpu":
        return radius_count_reference(centers, people, pmask, radius, r2)
    dev = _cuda_device(centers, "radius_count")
    c, k = centers.shape[0], people.shape[0]
    _check("centers", centers, torch.float32, (c, 2), dev)
    _check("people", people, torch.float32, (k, 2), dev)
    _check("pmask", pmask, torch.bool, (k,), dev)
    for name, t in (("centers", centers), ("people", people)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned (float2 rows)")
    plan = radius_plan(c, k)
    fn = load_library().radius_count_launch
    with torch.cuda.device(dev):
        out = torch.empty(c, dtype=torch.int32, device=dev)
        err = fn(centers.data_ptr(), people.data_ptr(), pmask.data_ptr(),
                 float(_radius_sq(radius) if r2 is None else r2), c, k,
                 plan.tiles_per_slice,
                 *plan.grid, out.data_ptr(), _stream(dev))
        if plan.grid[0] and plan.grid[1]:
            LAUNCHES["radius_count"] += 1
    _raise_on(err, "radius_count")
    return out
