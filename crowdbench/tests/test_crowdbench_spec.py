"""``BENCHMARK.json`` and the files it names: every cell's configuration,
traffic mix and per-layer metrics resolve by name, and the file keeps to
the benchmark's format."""

import json
import re

import pytest

from crowdbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_spec()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["crowdbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.resolve(cell)
    assert c.chips == 1
    assert c.config["name"] == cell.split(".")[0]
    assert c.traffic["name"] == cell.split(".", 1)[1]
    assert set(c.config["limits"]) == {
        "people", "centroids", "density_cells", "density_stats", "flow",
        "bottlenecks"}
    names = {m["name"] for m in c.end_to_end}
    # points_per_s is end to end only where its runs hold its bound; the
    # 1M scans report it per layer (loop.points_per_s)
    rate = ("points_per_s" if cell == "sensor_frame_40k.stream"
            else "loop.points_per_s")
    assert {"scan_p95_ms", "setup_s"} <= names
    assert rate in names | {m["name"] for m in c.per_layer}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in names


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.resolve("no_such_config.no_such_traffic")


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in metrics + BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(entry["name"]), entry["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"whole call", "pipeline host", "preprocess",
                      "density", "flow", "kernels", "device"}
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_configuration_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("crowdbench/configs/")
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and len(c["source"]) <= 200
        assert data["reduced"] == c["reduced"] == []
        assert data["pipeline"]["dtype"] == "float32"


def test_configuration_is_the_reference_apps():
    """The files' settings are MONOLITH_CONFIG's, field for field."""
    import dataclasses
    from lidar_ai_recommendation_software_tpu_torch.config import (
        MONOLITH_CONFIG)
    from crowdbench import run
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert dataclasses.asdict(run.pipeline_config(data["pipeline"])) \
            == dataclasses.asdict(MONOLITH_CONFIG)
