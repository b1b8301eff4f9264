"""Source variants of a kernel for the stage tools (``tools/scan_stages.py``,
``tools/kernel_stages.py``): a source with one change made in its text,
built by its own ``nvcc``, all at once, and loaded with ``ctypes``."""

from __future__ import annotations

import ctypes
import subprocess


def swap(text: str, old: str, new: str, tool: str) -> str:
    """``text`` with ``old`` replaced by ``new``; ``old`` must be in it
    exactly once, or the run stops."""
    if text.count(old) != 1:
        raise SystemExit(f"{tool}: {old!r} is not in the source exactly "
                         f"once")
    return text.replace(old, new)


def build(tool: str, variants: dict, fns) -> dict:
    """name -> the loaded library of each variant (``variants``: name ->
    (source text, ...)), built all at once into ``_build/<tool>/`` inside
    the package; those of ``fns`` (launch functions) that a variant holds
    are bound with the signatures the port's loader gives them."""
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    out_dir = kernels.BUILD_DIR / tool
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    jobs = {}
    for i, (name, (text, *_)) in enumerate(variants.items()):
        src, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        src.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tool}: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in (f for f in fns if hasattr(lib, f)):
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs
