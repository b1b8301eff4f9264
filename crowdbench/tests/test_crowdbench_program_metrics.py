"""The reader of the program's own start-up spans: on fixed aggregates, on
a program that keeps none, and in a traced run on the CPU."""

import pytest

from crowdbench import run, spec
from lidar_ai_recommendation_software_tpu_torch.utils import profiling

EMPTY = run.TracedRun({}, 0, None, [], {}, None)


def test_startup_counts_top_level_setup_and_the_first_analysis(
        monkeypatch):
    aggregates = {
        "setup.import": {"top_s": 1.5, "first_ms": 1500.0},
        "setup.pipeline": {"top_s": 0.5, "first_ms": 500.0},
        # inside the first analysis: counted there, not again
        "setup.kernels": {"top_s": 0.0, "first_ms": 2000.0},
        "pipeline.analyze": {"top_s": 30.0, "first_ms": 4000.0},
        "cli load": {"top_s": 7.0, "first_ms": 7000.0}}
    monkeypatch.setattr(profiling, "timings", lambda: aggregates)
    read = spec.metric_reader("pipeline.startup_s")
    assert read(EMPTY) == pytest.approx(6.0)


@pytest.mark.parametrize("aggregates", [
    {},
    # a program whose registry holds the CLI's stages alone, without the
    # top-level seconds
    {"cli load": {"count": 1, "total_s": 7.0, "mean_ms": 7000.0,
                  "last_ms": 7000.0}},
    {"setup.import": {"top_s": 1.5, "first_ms": 1500.0}},
])
def test_startup_reads_nothing_without_the_spans(monkeypatch, aggregates):
    monkeypatch.setattr(profiling, "timings", lambda: aggregates)
    assert spec.metric_reader("pipeline.startup_s")(EMPTY) is None


def test_traced_run_reads_the_startup():
    cell = spec.resolve("sensor_frame_40k.stream")
    cell.config["points"] = 5_000
    cell.traffic["pool"] = 2
    result, _, _ = run.bench(cell, 2**31 + 7, 0.3, True, device="cpu")
    assert result["correct"] is True
    got = result["metrics"]["pipeline.startup_s"]
    assert got["unit"] == "s" and got["value"] > 0
