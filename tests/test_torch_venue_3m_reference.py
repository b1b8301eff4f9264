"""``Pipeline.analyze`` on the CPU against the benchmark's plain reference
(``crowdbench/reference.py``), at a small size of the ``venue_scan_3m``
configuration: 65,536 points at its people density, with the centroid
route's switch (``clustering.SEGSUM_MAX_POINTS``) moved below the buffer,
so that the ``place_dense`` route runs through its plain twin as it runs
at 3,000,000 points on the card.

The program holds to the float64 reference within the configuration's
limits, the bfloat16 reference (the control) fails one of them, the
``density.centroids`` record names the route taken, and the configuration
file agrees with the venue and the fit it states: a 3,000,000-point scan
has a buffer above the switch and the column grid at its ceiling.
"""

import pytest
import torch

from crowdbench import compare, run, spec, venue
from lidar_ai_recommendation_software_tpu_torch.ops import clustering
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.utils import profiling

CELL = spec.resolve("venue_scan_3m.refresh")
KIND = CELL.kind
SETTINGS = CELL.config["pipeline"]
LIMITS = CELL.config["limits"]
SMALL = dict(CELL.config, points=65_536)
SWITCH = 32_768  # below the small scan's 65,536-row buffer


@pytest.fixture(scope="module")
def pipe():
    return Pipeline(run.pipeline_config(SETTINGS), device="cpu")


def _analyze(pipe, scan, switch=None):
    """One traced analysis, the switch moved to ``switch`` if given: the
    result and its ``density.centroids`` records."""
    with pytest.MonkeyPatch.context() as mp:
        if switch is not None:
            mp.setattr(clustering, "SEGSUM_MAX_POINTS", switch)
        with profiling.tracing() as rec:
            out = KIND.call(pipe, scan)
    cents = [sp for sc in rec.scans for sp in sc.spans
             if sp.name == "density.centroids"]
    return out, cents


@pytest.fixture(scope="module", params=[0, 2**31 + 7])
def case(request, pipe):
    """A scan of the seed's pool, the program's result on the place_dense
    route with its records, and the float64 reference's answer."""
    scan = KIND.make_pool(SMALL, CELL.traffic, request.param)[0]
    out, cents = _analyze(pipe, scan, SWITCH)
    ref = KIND.reference(scan, SETTINGS, torch.float64, "cpu")
    return scan, out, cents, ref


def _numbers(kept_light, kept_heavy, ref):
    return {**KIND.light(kept_light, ref),
            **KIND.heavy(kept_heavy, ref, "cpu")}


def test_program_holds_to_the_reference(case):
    scan, out, cents, ref = case
    assert KIND.points(scan) == 65_536
    assert [sp.attrs["route"] for sp in cents] == ["place_dense"]
    nums = _numbers(*KIND.keep(out), ref)
    assert set(nums) == set(LIMITS) == set(KIND.LIGHT + KIND.HEAVY)
    assert compare.judge(nums, LIMITS), nums
    assert ref["n_people"] > 1000 and ref["clustered"] > 40_000


def test_the_bfloat16_reference_fails_a_limit(case):
    scan, _, _, ref = case
    ctrl = KIND.reference(scan, SETTINGS, torch.bfloat16, "cpu")
    nums = _numbers(*KIND.as_kept(ctrl), ref)
    assert not compare.judge(nums, LIMITS), nums


def test_the_record_names_the_route(case, pipe):
    """One ``density.centroids`` span a scan, its route from the buffer's
    size alone: ``place_dense`` above the switch, ``indexed`` below it,
    each counted once; the two routes give the same people."""
    scan, out, cents, _ = case
    cap = pipe.fit_capacity(scan).capacity
    (placed,) = cents
    assert placed.attrs == {"route": "place_dense", "rows": cap.max_points,
                            "slots": cap.max_people}
    assert placed.counters == {"density.routes.place_dense": 1}
    again, (indexed,) = _analyze(pipe, scan)
    assert indexed.attrs == dict(placed.attrs, route="indexed")
    assert indexed.counters == {"density.routes.indexed": 1}
    a, b = out["people"], again["people"]
    assert torch.equal(a.mask, b.mask)
    torch.testing.assert_close(a.positions, b.positions, rtol=0, atol=1e-5)
    assert out["density"]["total_people"] == again["density"]["total_people"]


def test_the_configuration_is_the_venue_and_fit_it_states():
    """The 27 ha venue's size and crowd, and the fit of one of its
    3,000,000-point scans: a buffer of 3,145,728 rows (above the switch)
    and 1,280 x 1,280 clustering columns, wider than eps."""
    cfg = CELL.config
    assert (cfg["points"], cfg["people_per_100m2"]) == (3_000_000, 5.56)
    assert cfg["reduced"] == [] and cfg["assumed"] == []
    extent, people = venue.venue_size(cfg["points"], cfg["people_per_100m2"])
    assert extent == pytest.approx(259.8, abs=0.01) and people == 15_012
    names = {m["name"] for m in CELL.end_to_end}
    assert names == {"scan_p95_ms", "setup_s"}
    layer = {m["name"] for m in CELL.per_layer}
    assert {"density.people_ms", "kernels.people_roofline_pct"} <= layer
    scan = venue.scaled_venue(cfg["points"], seed=2**31 + 11,
                              people_per_100m2=cfg["people_per_100m2"])
    cap = Pipeline(run.pipeline_config(SETTINGS),
                   device="cpu").fit_capacity(scan).capacity
    assert cap.max_points == 3_145_728 > clustering.SEGSUM_MAX_POINTS
    assert (cap.cluster_cells_x, cap.cluster_cells_y) == (1280, 1280)
    assert 2 * extent / 1280 > SETTINGS["preprocess"]["dbscan_eps"]
    assert cap.max_people == 393_216
    for number in ("3,145,728", "1,280 x 1,280", "393,216", "place_dense"):
        assert number in cfg["program_paths"], number
