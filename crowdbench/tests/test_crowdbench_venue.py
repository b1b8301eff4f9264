"""The frozen traffic: the copied venue generator gives the port's
``scaled_venue`` bit for bit, and the sensor order only reorders."""

import json

import numpy as np
import pytest

from crowdbench import spec, traffic, venue


# the configurations' density (the reference fixture's 50 people on
# 30 x 30 m), and the port's default, a tenth of it
@pytest.mark.parametrize("n,seed,density", [
    (10_000, 42, 5.56), (40_960, 7, 5.56), (150_000, 2**31 + 5, 5.56),
    (1_000_000, 3_000_000_017, 5.56), (150_000, 9, 0.56)])
def test_generator_is_the_ports_bit_for_bit(n, seed, density):
    from lidar_ai_recommendation_software_tpu_torch import synthetic
    got = venue.scaled_venue(n, seed, density)
    want = synthetic.scaled_venue(n, seed=seed, people_per_100m2=density)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_configurations_keep_the_fixtures_people_per_area():
    """50 people on the fixture's 30 x 30 m and 10,000 points."""
    for name in ("venue_scan_1m", "sensor_frame_40k"):
        cfg = json.loads((spec.HERE / "configs" / f"{name}.json")
                         .read_text())
        assert venue.venue_size(10_000, cfg["people_per_100m2"]) == \
            (15.0, 50)


def test_fixture_is_the_golden_one():
    from lidar_ai_recommendation_software_tpu_torch import synthetic
    assert venue.sample_venue().tobytes() == \
        synthetic.sample_venue().tobytes()


def test_sensor_order_is_a_permutation_by_post_then_azimuth():
    extent, _ = venue.venue_size(40_960, 5.56)
    pts = venue.scaled_venue(40_960, 3, 5.56)
    perm = traffic.sensor_order(pts, extent, (4, 4), 0.2)
    assert np.array_equal(np.sort(perm), np.arange(len(pts)))
    q = pts[perm]
    post_edge = 2 * extent / 4
    col = np.clip(((q[:, 0] + extent) // post_edge).astype(int), 0, 3)
    row = np.clip(((q[:, 1] + extent) // post_edge).astype(int), 0, 3)
    post = col * 4 + row
    assert np.all(np.diff(post) >= 0)  # posts in turn
    cx = -extent + (col + 0.5) * post_edge
    cy = -extent + (row + 0.5) * post_edge
    az = np.floor((np.degrees(np.arctan2(q[:, 1] - cy, q[:, 0] - cx))
                   % 360.0) / 0.2)
    same = np.diff(post) == 0
    assert np.all(np.diff(az)[same] >= 0)  # by azimuth within a post


def test_pool_is_made_from_the_seed():
    cfg = {"points": 10_000, "people_per_100m2": 5.56}
    mix = {"pool": 3, "order": "generator"}
    seed = 2**31 + 99  # more than 32 signed bits hold
    a = traffic.make_pool(cfg, mix, seed)
    b = traffic.make_pool(cfg, mix, seed)
    c = traffic.make_pool(cfg, mix, seed + 1)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    assert len({x.tobytes() for x in a}) == 3
    assert a[0].tobytes() != c[0].tobytes()
    order = traffic.submissions(3, seed)
    first = [next(order) for _ in range(9)]
    assert sorted(first[:3]) == sorted(first[3:6]) == [0, 1, 2]
    again = traffic.submissions(3, seed)
    assert first == [next(again) for _ in range(9)]


def test_sensor_order_pool_holds_the_refresh_points():
    cfg = {"points": 10_000, "people_per_100m2": 5.56}
    plain = traffic.make_pool(cfg, {"pool": 2, "order": "generator"}, 5)
    posts = traffic.make_pool(cfg, {"pool": 2, "order": "sensor_posts",
                                    "posts": [4, 4],
                                    "azimuth_step_deg": 0.2}, 5)
    for a, b in zip(plain, posts):
        assert not np.array_equal(a, b)
        assert np.array_equal(np.unique(a, axis=0), np.unique(b, axis=0))
