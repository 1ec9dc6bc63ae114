"""One traced run of a benchmark cell, with the slice's device-idle time split
by the program span that was innermost open over it.

    python scripts/idle_by_span.py --workload <cell> --seed <n> --seconds <s> [--out PATH]

From the root of a checkout, on a CUDA card. Runs ``tierbench.harness.run_cell``
as ``tierbench/run.py --trace 1`` does and prints one JSON line: the card, the
check's verdict, every per-layer metric, the slice's busy and wall seconds,
and ``tierbench.program_spans.idle_by_span``: idle seconds by innermost
program span (``engine.step`` where the step's own code was innermost,
"outside the program" where no program span was open).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from tierbench import harness, program_spans, run

    if not torch.cuda.is_available():
        print("idle_by_span: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    res = harness.run_cell(cell, args.seed, args.seconds, True, "cuda:0", T_START)
    idle = program_spans.idle_by_span(res)
    line = {"workload": args.workload, "seed": args.seed, "card": run.card(),
            "correct": bool(res.correct),
            "metrics": {k: v["value"] for k, v in harness.per_layer(res).items()},
            "busy_s": res.trace.busy_s() if res.trace else None,
            "window_s": res.trace.window_s if res.trace else None,
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])) if idle else None}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
