"""The kind ``scan``: one call is ``Pipeline.analyze`` of one scan.

A kind says what one call of a cell is, for ``run.py`` and ``control.py``;
a configuration names its kind under ``"kind"``, and one that names none
is of this kind. A kind module provides:

  make_pool(config, traffic, seed)  the pool of items, made from the seed;
                                    an item is what one call takes
  points(item)                      the points one call analyses
  call(pipe, item)                  the timed call, on a ``Pipeline``
  reference(item, settings, dtype, device)
                                    the plain reference's answer
  clustered(ref)                    the points the call clusters, by the
                                    reference's count
  keep(result)                      (light, heavy): what the window keeps
                                    of every call, and what of a sample
  light(kept, ref), heavy(kept, ref, device)
                                    the numbers compared, named in
                                    ``LIGHT`` and ``HEAVY``; each has its
                                    limit in the configuration's
                                    ``limits``
  as_kept(ref)                      a reference's answer in the form
                                    ``keep`` gives: the control put in the
                                    program's place
  SPANS                             (module, attribute, span name) of
                                    entry points ``trace.instrument``
                                    wraps beside its own

This one is the traffic generator's scans (``traffic.py``) through the
reference's whole monolith analysis (``reference.py``), held to it by
``compare.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from crowdbench import compare, reference as plain, traffic as mixes

LIGHT = compare.LIGHT
HEAVY = compare.HEAVY
SPANS: Tuple[Tuple[str, str, str], ...] = ()


def make_pool(config: Dict, traffic: Dict, seed: int) -> List[np.ndarray]:
    return mixes.make_pool(config, traffic, seed)


def points(item: np.ndarray) -> int:
    return len(item)


def call(pipe, item: np.ndarray) -> Dict:
    return pipe.analyze(item)


def reference(item: np.ndarray, settings: Dict, dtype, device) -> Dict:
    return plain.analyze(item.astype(np.float32), settings, dtype, device)


def clustered(ref: Dict) -> int:
    return ref["clustered"]


def keep(out: Dict) -> Tuple[Dict, Dict]:
    """The result dicts without the full arrays, and the full arrays with
    the people still on the device: the window reads nothing back."""
    d = {k: v for k, v in out["density"].items()
         if k not in ("density_map", "density_grid")}
    f = {k: v for k, v in out["flow"].items() if k != "flow_vectors"}
    return ({"density": d, "flow": f,
             "recommendations": out["recommendations"]},
            {"people": out["people"], "density": out["density"],
             "flow": out["flow"]})


def light(kept: Dict, ref: Dict) -> Dict[str, float]:
    return compare.light(kept, ref)


def heavy(kept: Dict, ref: Dict, device) -> Dict[str, float]:
    if "centroids" not in kept:  # the program's people, read back now
        ppl = kept["people"]
        kept = dict(kept, centroids=ppl.positions[ppl.mask].double()
                    .cpu().numpy())
    return compare.heavy(kept, ref, device)


def as_kept(ref: Dict) -> Tuple[Dict, Dict]:
    """A reference's answer in the shape of ``Pipeline.analyze``'s dicts,
    its centroids read back already."""
    f = dict(ref["flow"], flow_vectors={"vectors": ref["flow"]["vectors"]})
    prog = {"density": ref["density"], "flow": f,
            "recommendations": ref["recommendations"],
            "centroids": ref["centroids"]}
    return prog, prog
