"""A run driven on the CPU at a size a test can hold: the result line's
keys, a run without a card, the modules loaded, the reference against the
port, the control and the faults that ``correct`` has to catch."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from crowdbench import compare, control, run, spec, traffic

ROOT = str(spec.ROOT)
POINTS = 5_000  # a 21 x 21 m venue, 25 person discs


def small_cell(name="sensor_frame_40k.stream", pool=2):
    cell = spec.resolve(name)
    cell.config["points"] = POINTS
    cell.traffic["pool"] = pool
    return cell


def drive(cell, seed=2**31 + 7, trace=False):
    result, info, lines = run.bench(cell, seed, 0.3, trace, device="cpu")
    return result, lines


def test_last_line_keys_and_checks():
    result, lines = drive(small_cell())
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"points_per_s", "scan_p95_ms",
                                      "setup_s"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == set(compare.LIGHT + compare.HEAVY)
    assert all(set(v) == {"value", "limit"}
               for v in result["checks"].values())
    assert lines[-1].startswith("flow ") and " limit " in lines[-1]
    json.loads(json.dumps(result))


def test_traced_run_reads_the_span_metrics():
    result, _ = drive(small_cell(), trace=True)
    assert result["correct"] is True
    for name in ("pipeline.fit_ms", "pipeline.host_ms",
                 "preprocess.cluster_ms", "density.ms", "flow.ms"):
        assert result["metrics"][name]["value"] > 0
    # no card, no device trace: those readers return nothing
    assert "device.idle_pct" not in result["metrics"]


def test_venue_cells_report_the_rate_per_layer():
    cell = small_cell("venue_scan_1m.sensor_order")
    result, _ = drive(cell)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"scan_p95_ms", "setup_s"}
    result, _ = drive(cell, trace=True)
    assert result["correct"] is True
    assert result["metrics"]["loop.points_per_s"]["value"] > 0


def test_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "crowdbench.run", "--workload",
         "venue_scan_1m.refresh", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_no_jax_module_is_loaded():
    code = ("import json, sys; sys.argv = ['x'];"
            "from crowdbench import run, spec;"
            "cell = spec.resolve('venue_scan_1m.sensor_order');"
            f"cell.config['points'] = {POINTS}; cell.traffic['pool'] = 1;"
            "res, _, _ = run.bench(cell, 3, 0.2, True, device='cpu');"
            "print(json.dumps([res['correct'], run.forbidden_modules(),"
            " sorted(m for m in sys.modules if m.split('.')[0] =="
            " 'lidar_ai_recommendation_software_tpu_torch')[:1]]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    correct, found, port = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct is True
    assert found == []
    assert port  # the port's name starts with the JAX package's
    assert run.forbidden_modules.__doc__


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    monkeypatch.setitem(sys.modules, "lidar_ai_recommendation_software_tpu"
                        "_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]


def test_reference_imports_nothing_of_the_program():
    import ast
    for name in ("reference.py", "recommend.py", "venue.py", "compare.py"):
        tree = ast.parse((spec.HERE / name).read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)]
        assert not any(m.startswith("lidar_ai") or m.split(".")[0] == "jax"
                       for m in mods), name


@pytest.mark.parametrize("order", ["generator", "sensor_posts"])
def test_reference_agrees_with_the_port_on_the_cpu(order):
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    cell = small_cell("venue_scan_1m.sensor_order" if order != "generator"
                      else "venue_scan_1m.refresh", pool=2)
    settings = cell.config["pipeline"]
    pool = traffic.make_pool(cell.config, cell.traffic, 11)
    pipe = Pipeline(run.pipeline_config(settings), device="cpu")
    for pts in pool:
        out = pipe.analyze(pts)
        ref = run.references(cell.kind, [pts], [0], settings, "cpu")[0]
        prog = {"density": out["density"], "flow": out["flow"],
                "recommendations": out["recommendations"],
                "centroids": out["people"].positions[out["people"].mask]
                .double().numpy()}
        nums = {**compare.light(prog, ref), **compare.heavy(prog, ref,
                                                            "cpu")}
        assert ref["n_people"] == out["density"]["total_people"] > 0
        assert nums["people"] == nums["centroids"] == 0
        assert nums["density_cells"] == 0 and nums["density_stats"] < 1e-6
        assert nums["flow"] < 1e-5 and nums["bottlenecks"] < 1e-5
        assert compare.judge(nums, cell.config["limits"])


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 4_000_000_001])
def test_control_fails(seed):
    """The reference in bfloat16 in the program's place fails the limits
    (the chip's readings at the cells' sizes are in PERF.md)."""
    cell = small_cell(pool=1)
    settings = cell.config["pipeline"]
    pool = traffic.make_pool(cell.config, cell.traffic, seed)
    refs = run.references(cell.kind, pool, [0], settings, "cpu")
    verdict = control.control_verdict(cell.kind, pool, refs, settings,
                                      cell.config["limits"], "cpu")
    assert verdict["correct"] is False
    assert not compare.judge(verdict["worst"], cell.config["limits"])


def _move_people(orig):
    def extract_people(processed, config):
        people = orig(processed, config)
        people.positions = people.positions + 0.5
        return people
    return extract_people


def _nudge_flow(orig):
    def analyze_flow(*args):
        res = orig(*args)
        res.vectors = res.vectors * 1.01
        return res
    return analyze_flow


def _drop_an_issue(orig):
    def generate_recommendations(*args):
        rec = orig(*args)
        rec["issues"] = rec["issues"][1:]
        return rec
    return generate_recommendations


FAULTS = ["answer altered: the people moved 0.5 m where they are extracted",
          "answer altered: the flow field scaled where it is made",
          "answer altered: a recommendation dropped where they are made",
          "half the scan left out", "state unchanged: the last answer again"]


@pytest.mark.parametrize("fault", FAULTS)
def test_correct_is_false_under_each_fault(fault, monkeypatch):
    from lidar_ai_recommendation_software_tpu_torch import pipeline
    from lidar_ai_recommendation_software_tpu_torch.models import (
        density, flow)
    if fault.startswith("answer altered: the people"):
        monkeypatch.setattr(density, "extract_people",
                            _move_people(density.extract_people))
    elif fault.startswith("answer altered: the flow"):
        monkeypatch.setattr(flow, "analyze_flow",
                            _nudge_flow(flow.analyze_flow))
    elif fault.startswith("answer altered: a recommendation"):
        monkeypatch.setattr(pipeline, "generate_recommendations",
                            _drop_an_issue(pipeline.generate_recommendations))
    elif fault.startswith("half"):
        orig = pipeline.Pipeline.analyze
        monkeypatch.setattr(pipeline.Pipeline, "analyze",
                            lambda self, pts: orig(self, pts[:len(pts) // 2]))
    else:
        orig = pipeline.Pipeline.analyze
        last = {}

        def stale(self, pts):
            out = last.get("out") or orig(self, pts)
            last["out"] = out
            return out
        monkeypatch.setattr(pipeline.Pipeline, "analyze", stale)
    result, _ = drive(small_cell())
    assert result["correct"] is False
    assert result["failed"] > 0
    assert result["attempted"] >= result["failed"]
    assert np.isfinite(result["metrics"]["points_per_s"]["value"])
