"""``Pipeline.analyze_sequence`` on the CPU against the benchmark's plain
tracking reference (``crowdbench/tracking.py``), at a small size of the
``sequence_4x100k`` configuration: 4 frames of 10,000 points, 50 people.

The program holds to the float64 reference within the configuration's
limits, the bfloat16 reference (the control) does not, and the program's
person-like people come in the reference's cluster order, the row order
on which the reference states the tracking's inverted-map rule.
"""

import numpy as np
import pytest
import torch

from crowdbench import compare, run, spec
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

CELL = spec.resolve("sequence_4x100k.track")
KIND = CELL.kind
SETTINGS = CELL.config["pipeline"]
LIMITS = CELL.config["limits"]
SMALL = dict(CELL.config, points=10_000, people=50)


@pytest.fixture(scope="module")
def pipe():
    return Pipeline(run.pipeline_config(SETTINGS), device="cpu")


@pytest.fixture(scope="module", params=[0, 2**31 + 3])
def case(request, pipe):
    """The first window of a seed's walk: the program's result and the
    float64 reference's."""
    window = KIND.make_pool(SMALL, CELL.traffic, request.param)[0]
    out = KIND.call(pipe, window)
    ref = KIND.reference(window, SETTINGS, torch.float64, "cpu")
    return window, out, ref


def _numbers(kept_light, kept_heavy, ref):
    return {**KIND.light(kept_light, ref),
            **KIND.heavy(kept_heavy, ref, "cpu")}


def test_program_holds_to_the_reference(case):
    window, out, ref = case
    assert len(window.frames) == 4 and KIND.points(window) == 40_000
    nums = _numbers(*KIND.keep(out), ref)
    assert set(nums) == set(LIMITS) == set(KIND.LIGHT + KIND.HEAVY)
    assert compare.judge(nums, LIMITS), nums
    assert len(ref["flow"]["vectors"]) > 0  # people were tracked
    assert all(len(t) > 40 for t in ref["tracked"])


def test_the_bfloat16_reference_fails_a_limit(case):
    window, _, ref = case
    ctrl = KIND.reference(window, SETTINGS, torch.bfloat16, "cpu")
    nums = _numbers(*KIND.as_kept(ctrl), ref)
    assert not compare.judge(nums, LIMITS), nums


def test_person_like_people_come_in_cluster_order(case):
    _, out, ref = case
    seq = out["tracked_people"]
    assert seq.positions.shape[0] == len(ref["tracked"]) == 4
    for t, want in enumerate(ref["tracked"]):
        got = seq.positions[t][seq.mask[t]].double().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # slots past the clusters are empty, so the last row to name a frame's
    # row 0 is an empty one
    assert len(ref["centroids"]) < seq.positions.shape[1]
