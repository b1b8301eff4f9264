#!/usr/bin/env python3
"""The tail of the column-grid clustering on one NVIDIA GPU: from the
stream-order labels to dense cluster ids in point order.

    python3 -m tools.tail_stages     (from the repository root)

It prints the card's name and power limit. Then, on the clustering inputs
of ``chip_smoke.py``'s 262,144-, 1M- and 3M-point scans and of the first
frame of its 100,000-point temporal sequence (labels from the card's own
column kernels), ``dense_tail`` as the port launches it (two launches,
one a phase): the time replayed from a CUDA graph
(``chip_smoke.graph_ms``), the time with CUDA events over direct calls
(``chip_smoke.cuda_ms``, which includes the host's cost of a call) and the
kernels one call launches, read from a CUDA graph that captured it
(``chip_smoke.device_kernels``, memsets left out); and the tail's
bound: point_stream and the result once each and a label per placed
point, at 3.35 TB/s. ``dense_tail`` is held bit-equal to the plain
tail before it is timed. Then, timed from a CUDA graph and held bit-equal
too: ``dense_tail`` under other launch plans than
``columns.dense_tail_plan``'s (a block a word of 32 points up to 1,024
blocks; the blocks the card holds at once, 4 an SM), and its stages, each
a variant of ``csrc/dense_tail.cu`` with one change made in its text
(``tools/variants.py``): the first launch alone (the second is the whole
less that), and the whole with the words read past L1.
The last line is a JSON record of every number.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from tools.variants import build, swap

# stage -> (the text it replaces, what it puts there), or None: as built
_STAGES = {
    "the first launch alone": (
        "  dense_tail_phase2<<<blocks, kThreads, 0, s>>>(a);\n", ""),
    "whole": None,
    "whole, words through L2 only": ("__ldca(a.words + ",
                                     "__ldcg(a.words + "),
}


def _plan_by_words(n: int, most: int):
    """Blocks of whole words of 32 points, as many as there are words up
    to ``most`` (and TAIL_MAX_BLOCKS)."""
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    words = max(1, -(-n // 32))
    per_block = 32 * -(-words // min(words, most, C.TAIL_MAX_BLOCKS))
    return C.TailPlan(max(1, -(-n // per_block)), per_block)


def _launch(lib, labels, pst, plan):
    """One call of a variant's launch function under ``plan``, as
    ``columns.dense_tail`` makes it."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    n = pst.shape[0]
    dense = torch.empty(n, dtype=torch.int32, device=pst.device)
    n_clusters = torch.empty((), dtype=torch.int32, device=pst.device)
    scratch = torch.empty(2 * -(-n // 32) + plan.blocks, dtype=torch.int32,
                          device=pst.device)
    kernels._raise_on(lib.dense_tail_launch(
        labels.data_ptr(), pst.data_ptr(), n, plan.blocks, plan.per_block,
        dense.data_ptr(), scratch.data_ptr(), n_clusters.data_ptr(),
        kernels._stream(pst.device)), "dense_tail variant")
    return dense, n_clusters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tail_stages: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels

    dev = torch.device("cuda", 0)
    ident = S.gpu_identity()
    print(ident)
    lib = kernels.load_library()
    held = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    src = (Path(kernels.CSRC_DIR) / "dense_tail.cu").read_text()
    libs = build("tail_stages", {
        stage: (swap(src, *cut, "tail_stages") if cut else src,)
        for stage, cut in _STAGES.items()}, ("dense_tail_launch",))
    cases = [S.scan_case(name, scaled_venue(n)) for n, name in S.COLUMN_SCANS]
    cases.append(S.scan_case(S.SEQUENCE_FRAME, S.sequence_frames()[1][0]))
    record = {"card": ident}
    for name, pts, mask, *args in cases:
        labels, pst, n_occ = S.clustering_labels(dev, pts, mask, *args)
        n = pst.shape[0]
        b_ms, b_by = S.bound(4 * n + 4 * n_occ + 4 * n + 4, 0)
        want, want_n = C.dense_tail_reference(labels, pst)

        def held_equal(what, fn):
            dense, n_clusters = fn()
            torch.cuda.synchronize()
            S.require(torch.equal(dense, want)
                      and torch.equal(n_clusters, want_n),
                      f"{what} differs from the plain tail: {name}")

        variants = {"dense_tail": lambda: C.dense_tail(labels, pst)}
        got = {}
        for variant, fn in variants.items():
            held_equal(variant, fn)
            seen = S.device_kernels(fn)
            got[variant] = {"graph_ms": S.graph_ms(fn),
                            "ms": S.cuda_ms(fn),
                            "kernels": sum(seen.values())}
            print(f"{name}, {variant}: {got[variant]['graph_ms']:.6f} ms "
                  f"from a CUDA graph, {got[variant]['ms']:.6f} ms with "
                  f"events, {got[variant]['kernels']} kernels a call {seen}")
        print(f"{name}: N {n}, {n_occ} placed, {int(want_n)} clusters; bound "
              f"{b_ms:.6f} ms ({b_by}); plan {C.dense_tail_plan(n)}")
        plans = {"a block a word, up to 1,024": _plan_by_words(n, n),
                 f"the blocks the card holds, {held}": _plan_by_words(n,
                                                                      held)}
        for what, plan in plans.items():
            fn = (lambda plan=plan: _launch(lib, labels, pst, plan))
            held_equal(what, fn)
            got[f"plan: {what}"] = {"graph_ms": S.graph_ms(fn),
                                    "blocks": plan.blocks,
                                    "per_block": plan.per_block}
            print(f"{name}, plan {what} ({plan}): "
                  f"{got[f'plan: {what}']['graph_ms']:.6f} ms from a CUDA "
                  f"graph")
        for stage, variant_lib in libs.items():
            fn = (lambda v=variant_lib:
                  _launch(v, labels, pst, C.dense_tail_plan(n)))
            if stage.startswith("whole"):
                held_equal(stage, fn)
            got[f"stage: {stage}"] = {"graph_ms": S.graph_ms(fn)}
            print(f"{name}, stage {stage}: "
                  f"{got[f'stage: {stage}']['graph_ms']:.6f} ms from a CUDA "
                  f"graph")
        record[name] = {"n": n, "placed": n_occ, "bound_ms": b_ms, **got}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
