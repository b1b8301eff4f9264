"""A new kind of call joins the benchmark by new files and entries alone.

In a copy of the benchmark's tree this adds a kind whose call is a pair of
frames (each through ``Pipeline.analyze``, each held to the plain
reference), with an entry point of its own to span; a configuration, a
traffic mix, a cell and two per-layer metrics in ``BENCHMARK.json``; and
the metrics' readers, one of the kind's span and one of the port's own
span records. A traced run of the cell on the CPU comes out correct with
both metrics, and no file that was there before has changed.
"""

import hashlib
import json
import shutil

from crowdbench import run, spec

TOY_KIND = '''
"""The kind ``frame_pair``: one call analyses two frames."""

import numpy as np

from crowdbench import compare, reference as plain, traffic as mixes

LIGHT, HEAVY = compare.LIGHT, compare.HEAVY
SPANS = (("lidar_ai_recommendation_software_tpu_torch.pipeline",
          "generate_recommendations", "pair.recommend"),)


def make_pool(config, traffic, seed):
    frames = mixes.make_pool(config, dict(traffic, pool=2 * traffic["pool"]),
                             seed)
    return [tuple(frames[i:i + 2]) for i in range(0, len(frames), 2)]


def points(item):
    return sum(len(f) for f in item)


def call(pipe, item):
    return [pipe.analyze(f) for f in item]


def reference(item, settings, dtype, device):
    return [plain.analyze(f.astype(np.float32), settings, dtype, device)
            for f in item]


def clustered(refs):
    return sum(r["clustered"] for r in refs)


def keep(outs):
    light = [{"density": o["density"], "flow": o["flow"],
              "recommendations": o["recommendations"]} for o in outs]
    heavy = [dict(o, centroids=o["people"].positions[o["people"].mask]
                  .double().cpu().numpy()) for o in outs]
    return light, heavy


def light(kept, refs):
    return compare.worst([compare.light(k, r) for k, r in zip(kept, refs)],
                         LIGHT)


def heavy(kept, refs, device):
    return compare.worst([compare.heavy(k, r, device)
                          for k, r in zip(kept, refs)], HEAVY)


def as_kept(refs):
    progs = [{"density": r["density"], "recommendations":
              r["recommendations"], "centroids": r["centroids"],
              "flow": dict(r["flow"], flow_vectors={
                  "vectors": r["flow"]["vectors"]})} for r in refs]
    return progs, progs
'''

SPAN_READER = '''
def read(run):
    if not run.scans or "pair.recommend" not in run.spans:
        return None
    return 1e3 * sum(run.spans["pair.recommend"]) / run.scans
'''

RECORD_READER = '''
def read(run):
    spans = [sp for scan in run.records for sp in scan.spans
             if sp.name == "pipeline.analyze"]
    if not run.recorded or not spans:
        return None
    return len(spans) / run.recorded
'''


def _digests(root):
    """Every file under ``root`` but Python's bytecode caches."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_kind_joins_by_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    home = root / spec.HERE.name
    shutil.copytree(spec.HERE, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(home)
    bench_before = spec.load_spec(root)

    config = json.loads((home / "configs" / "sensor_frame_40k.json")
                        .read_text())
    config.update(name="frame_pair", kind="frame_pair", points=3_000)
    new = {
        "kinds/frame_pair.py": TOY_KIND,
        "configs/frame_pair.json": json.dumps(config, indent=1),
        "traffic/pairs.json": json.dumps(
            {"name": "pairs", "pool": 1, "order": "generator",
             "why": "two frames a call"}),
        "metrics/pair.recommend_ms.py": SPAN_READER,
        "metrics/pair.analyses.py": RECORD_READER,
    }
    for rel, text in new.items():
        (home / rel).write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "frame_pair", "source": "a test", "reduced": [],
        "file": f"{spec.HERE.name}/configs/frame_pair.json",
        "why": "two frames a call"})
    bench["workloads"].append({
        "name": "frame_pair.pairs", "config": "frame_pair",
        "traffic": "pairs", "chips": 1, "why": "two frames a call"})
    bench["per_layer"] += [
        {"name": "pair.recommend_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "pipeline host",
         "moves": "scan_p95_ms", "workloads": ["frame_pair.pairs"]},
        {"name": "pair.analyses", "unit": "calls", "better": "lower",
         "source": "program_span", "layer": "pipeline host",
         "moves": "scan_p95_ms", "workloads": ["frame_pair.pairs"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    cell = spec.resolve("frame_pair.pairs", root=root)
    assert cell.kind.__file__ == str(home / "kinds" / "frame_pair.py")
    result, info, lines = run.bench(cell, 2**31 + 5, 0.6, True,
                                    device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["metrics"]["pair.recommend_ms"]["value"] > 0
    # two ``Pipeline.analyze`` records of the port a call
    assert result["metrics"]["pair.analyses"]["value"] == 2.0
    assert set(result["checks"]) == set(cell.kind.LIGHT + cell.kind.HEAVY)
    assert "pool 1 x 6,000 points" in info[1]

    after = _digests(home)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(new)
    bench_after = spec.load_spec(root)
    for key, value in bench_before.items():
        if isinstance(value, list):  # entries added after the old ones
            assert bench_after[key][:len(value)] == value, key
        else:
            assert bench_after[key] == value, key
