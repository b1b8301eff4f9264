"""The readings that the limits of ``correct`` are set from.

    python3 -m crowdbench.control --workload <cell> --seeds <n> \
        --first-seed <s> --seconds <s> [--out <file>]

For each of ``--seeds`` seeds, in one process on the card: the cell's pool
and a short window of its closed loop through the cell's kind (for
``scan``, ``Pipeline.analyze``), every scan judged as a run judges it
(``run.judge``): the program's readings, the worst over the window. Then
the control, the plain reference computed in bfloat16 (the configuration
states float32 points) put in the program's place on the same scans
(``as_kept`` of the kind) and judged the same way: the control's
readings. Each of the control's scans is judged against the limits by
``compare.judge``, as a run judges the program's: the control has to come
out not correct on every seed, and the program correct. One JSON line a
seed, and a summary: for each number the largest program reading and the
smallest control reading, beside the limit, and on how many seeds each
side came out correct. Exits 1 where the control comes out correct on a
seed or the program does not.

Not a part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from crowdbench import compare, run, spec, traffic


def control_verdict(kind, pool, refs, settings, limits, device) -> dict:
    """The bfloat16 reference in the program's place: the worst of each
    number, and whether every scan passes ``compare.judge``."""
    ctrl = run.references(kind, pool, refs, settings, device,
                          torch.bfloat16)
    rows = []
    for i, ref in refs.items():
        light, heavy = kind.as_kept(ctrl[i])
        rows.append(kind.light(light, ref))
        rows.append(kind.heavy(heavy, ref, device))
    return {"worst": compare.worst(rows, list(kind.LIGHT)
                                   + list(kind.HEAVY)),
            "correct": all(compare.judge(r, limits) for r in rows)}


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    settings, kind = cell.config["pipeline"], cell.kind
    pool = kind.make_pool(cell.config, cell.traffic, seed)
    pipe = Pipeline(run.pipeline_config(settings), device=device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    for item in pool:
        kind.call(pipe, item)
    kept = run.Kept(seed, kind)
    win = run.closed_loop(pipe, pool, traffic.submissions(len(pool), seed),
                          seconds, kept, None, sync)
    del pipe
    refs = run.references(kind, pool, range(len(pool)), settings, device)
    limits = cell.config["limits"]
    verdict = run.judge(pool, kept, settings, limits, device, refs)
    ctrl = control_verdict(kind, pool, refs, settings, limits, device)
    return {"seed": seed, "scans": win["attempted"],
            "errors": win["errors"], "judged": verdict["judged"],
            "people": [r.get("n_people") for r in refs.values()],
            "clustered": [kind.clustered(r) for r in refs.values()],
            "program": verdict["worst"],
            "program_correct": not win["errors"] and not verdict["wrong"],
            "control": ctrl["worst"], "control_correct": ctrl["correct"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    rows = []
    out = open(args.out, "a") if args.out else None
    try:
        for k in range(args.seeds):
            row = readings(cell, args.first_seed + k, args.seconds, "cuda")
            rows.append(row)
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    finally:
        if out:
            out.close()
    limits = cell.config["limits"]
    for k in limits:
        prog = max(r["program"][k] for r in rows)
        ctrl = min(r["control"][k] for r in rows)
        print(f"{k}: program max {prog!r}, control min {ctrl!r}, "
              f"limit {limits[k]!r}, control fails: {ctrl > limits[k]}, "
              f"program passes: {prog <= limits[k]}")
    ctrl_ok = sum(r["control_correct"] for r in rows)
    prog_ok = sum(r["program_correct"] for r in rows)
    print(f"control correct on {ctrl_ok} of {len(rows)} seeds; "
          f"program correct on {prog_ok} of {len(rows)} seeds")
    return 0 if ctrl_ok == 0 and prog_ok == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
