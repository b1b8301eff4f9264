"""Failure detection and graceful degradation.

The reference's only failure handling is logged-error-and-return-None
around DB calls (SURVEY.md §5). A deployment on a card needs more: cards
fall off the bus and drivers wedge. This module provides:

  - ``device_healthy``: a bounded-time liveness probe (a 128 x 128
    matmul on the device with a host read-back, executed in a watchdog
    thread so a wedged device cannot hang the caller);
  - ``device_answers_in_subprocess``: the same matmul in a fresh
    process, which gets a CUDA context of its own on the same device, so
    a sticky error of this process's context (an illegal address or a
    failed launch in a kernel, which every later call of the process
    reports again) does not read as a lost card;
  - ``FallbackPipeline``: runs the card's pipeline, and when it fails on a
    card that no longer answers the subprocess probe, degrades to the
    port's own ``Pipeline(config, device="cpu")``, whose results equal
    the card's (``chip_smoke.py``) and the JAX package's (the tests), so
    callers keep working through an outage at CPU speed. It degrades only
    when a caller asks for it (``--fallback-cpu``); any other failure is
    raised.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import threading
import time
from typing import Dict

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

logger = logging.getLogger("lidar_tpu.resilience")


def matmul_probe(device: torch.device | str = "cuda") -> float:
    """A 128 x 128 matmul on ``device``, read back to the host."""
    x = torch.ones((128, 128), device=device)
    return float((x @ x).sum())


def device_healthy(timeout_s: float = 10.0, attempts: int = 3,
                   retry_delay_s: float = 5.0, probe=None,
                   device: torch.device | str = "cuda") -> bool:
    """True when ``device`` executes + returns within budget.

    A device error can be transient (the next probe succeeds), so a
    single failed probe must not condemn the device: retry up to
    ``attempts`` times with a flat delay. A probe that *hangs* (timeout)
    still counts as one failed attempt — the per-attempt budget is
    ``timeout_s``. ``probe`` replaces ``matmul_probe(device)``.
    """
    if probe is None:
        def probe():
            return matmul_probe(device)

    for i in range(attempts):
        # A plain daemon thread, NOT ThreadPoolExecutor: pool workers are
        # non-daemon, so a probe wedged inside a device call would block
        # interpreter exit — the caller would print its degraded record
        # and then hang until killed from outside. A daemon thread lets
        # the process exit cleanly.
        box: Dict[str, object] = {}

        def run():
            try:
                # coerce + finiteness-check INSIDE the guarded worker: a
                # custom probe returning a non-numeric value must read as
                # an unhealthy probe, not a TypeError out of the caller
                box["val"] = float(probe())
                box["ok"] = bool(np.isfinite(box["val"]))
            except Exception as e:  # runtime error, no device
                box["err"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=timeout_s)
        if box.get("ok"):
            return True
        if t.is_alive():
            logger.warning("device health probe timed out "
                           "(attempt %d/%d, %.0fs)", i + 1, attempts,
                           timeout_s)
        else:
            # %r, not %s: exceptions raised with empty messages must
            # still log their class
            logger.warning("device health probe failed (attempt %d/%d):"
                           " %r", i + 1, attempts,
                           box.get("err", box.get("val")))
        if i + 1 < attempts:
            time.sleep(retry_delay_s)
    return False


# the probe's budget when a pipeline failure asks whether the card is gone:
# a fresh interpreter imports torch and makes a CUDA context first
HEALTH_TIMEOUT_S = 60.0

# The subprocess probe: ``matmul_probe``'s matmul on the device named by
# the first argument; exit 0 when it returns the right sum.
_PROBE_CODE = (
    "import sys, torch\n"
    "x = torch.ones((128, 128), device=sys.argv[1])\n"
    "sys.exit(0 if float((x @ x).sum()) == 128.0 ** 3 else 1)\n")


def device_answers_in_subprocess(device: torch.device | str = "cuda",
                                 timeout_s: float = HEALTH_TIMEOUT_S
                                 ) -> bool:
    """True when a fresh Python process runs a 128 x 128 matmul on
    ``device`` and exits 0 within ``timeout_s`` (the child is killed at the
    limit). The child's CUDA context is its own: an error that poisoned
    this process's context does not reach it."""
    try:
        res = subprocess.run([sys.executable, "-c", _PROBE_CODE,
                              str(device)], capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        logger.warning("device probe in a subprocess timed out (%.0fs)",
                       timeout_s)
        return False
    if res.returncode != 0:
        logger.warning("device probe in a subprocess failed (exit %d): %s",
                       res.returncode, res.stderr.strip()[-2000:])
    return res.returncode == 0


class FallbackPipeline:
    """Pipeline wrapper that degrades to the port's own pipeline on the
    CPU when the card is lost; the results are the card's
    (``chip_smoke.py`` holds them equal). Not to the CPU oracle
    (``oracle/reference.py``), as the JAX package's wrapper does: the
    oracle's result has no ``people``, which the pipeline's keeps.

    A failure on a card that still answers the probe is re-raised: a
    kernel that does not build or launch, reads an illegal address, or a
    bad shape, is a fault of the program, never a reason to compute on the
    CPU instead. The probe runs in a subprocess, since a sticky CUDA error
    fails every later call of this process, a probe's too.
    """

    def __init__(self, pipeline=None):
        self.pipeline = pipeline or Pipeline()
        self.fallbacks = 0

    def analyze(self, points: np.ndarray) -> Dict:
        try:
            return self.pipeline.analyze(points)
        except Exception as e:
            # one attempt: the probe gates a fast failover to the CPU
            if device_answers_in_subprocess(self.pipeline.device):
                raise
            logger.error("device pipeline failed (%s) and the device is "
                         "lost; falling back to the CPU", e)
            return self._analyze_cpu(points)

    def _analyze_cpu(self, points: np.ndarray) -> Dict:
        self.fallbacks += 1
        out = Pipeline(self.pipeline.config, device="cpu").analyze(points)
        out["degraded"] = True
        return out
