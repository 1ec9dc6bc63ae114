"""Readings that set a cell's ``logit_gap`` limit, on the card, in one process.

    python tierbench/control.py --workload <cell> --seeds 1,2,3 --seconds 15 \
        [--control-seeds 1,2,3]

For each seed, one run of the cell at its own load and sizes (the window
``--seconds`` long, the run's sample of finished requests), then the plain
reference over the sample; for the seeds of ``--control-seeds`` also the
control: the reference computed with float8 e4m3 matmuls (the precision
below the configuration's bf16), its first token at each served position
read against the float32 reference, and its page masses against the
reference's. Prints one JSON line a seed and a summary: for each number
``harness.numbers`` gives, the program's largest over the seeds (the lower
reading) and the control's smallest (the upper reading). Writes them to
``build/tierbench/control-<cell>.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from tierbench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t,
                               control="fp8" if seed in controls else None)
        prog = harness.numbers(res.gaps)
        row = {"seed": seed, **{f"program_{k}": v for k, v in prog.items() if k[0] != "_"},
               "gaps": [g["gap"] for g in res.gaps], "tokens": [g["tokens"] for g in res.gaps],
               "backlog": res.e2e["_backlog"], "setup_s": res.setup_s,
               "run_s": time.perf_counter() - t,
               **{k: v for k, v in res.e2e.items() if not k.startswith("_")}}
        if seed in controls:
            ctl = harness.numbers(res.gaps, control=True)
            row.update({f"control_{k}": v for k, v in ctl.items() if k[0] != "_"})
            row["control_gaps"] = [g["cgap"] for g in res.gaps]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del res
    summary = {"workload": args.workload, "seeds": len(rows), "control_seeds": sorted(controls)}
    for name in ("logit_gap", "mean_logit_gap", "hotness_gap", "mean_hotness_gap"):
        summary[f"lower_{name}"] = max(r[f"program_{name}"] for r in rows)
        summary[f"upper_{name}"] = min((r[f"control_{name}"] for r in rows
                                        if f"control_{name}" in r), default=None)
    out = harness.OUT
    out.mkdir(parents=True, exist_ok=True)
    (out / f"control-{args.workload}.json").write_text(json.dumps({"rows": rows, **summary}))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
