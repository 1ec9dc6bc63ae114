"""Device kernels in one replayed decode step, from one traced run of a
benchmark cell.

    python scripts/step_kernel_count.py --workload <cell> --seed <n> --seconds <s> [--root DIR]

On a CUDA card. Runs ``tierbench.harness.run_cell`` as ``tierbench/run.py
--trace 1`` does, from the checkout at ``--root`` (this one by default; pass
an unpacked parent to count its step), and reads the profiled slice's Chrome
trace before the harness drops it. The device kernels that a
``cudaGraphLaunch`` issued share its correlation id: each such group is one
replay of the captured decode step. Prints one JSON line: the card, the
replays seen, the kernels in one replay (median), a replay's device time
split into GEMMs (a name with ``gemm``, ``nvjet`` or ``cutlass``), kernel #1
(``fused_tiered_attention``) and the rest (ms, medians), and the twenty
kernels with the most time a replay (launches and ms a replay).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

GEMM = re.compile(r"gemm|nvjet|cutlass", re.I)
ATTENTION = re.compile(r"fused_tiered_attention_kernel")


def replays(events) -> list:
    """The device kernels of each ``cudaGraphLaunch``: [[(name, ms), ...]]."""
    launches = {e["args"]["correlation"] for e in events
                if e.get("ph") == "X" and e.get("name") == "cudaGraphLaunch"
                and "correlation" in e.get("args", {})}
    by = defaultdict(list)
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") == "kernel" and corr in launches:
            by[corr].append((e["name"], float(e["dur"]) * 1e-3))
    return [by[c] for c in sorted(by)]


def summary(groups) -> dict:
    if not groups:
        return {"replays": 0}

    def med(f):
        return statistics.median(f(g) for g in groups)

    per = defaultdict(lambda: [0, 0.0])
    for g in groups:
        for name, ms in g:
            per[name][0] += 1
            per[name][1] += ms
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:20]
    n = len(groups)
    return {
        "replays": n,
        "kernels_per_replay": med(len),
        "device_ms_per_replay": med(lambda g: sum(ms for _, ms in g)),
        "gemm_ms": med(lambda g: sum(ms for nm, ms in g if GEMM.search(nm))),
        "attention_ms": med(lambda g: sum(ms for nm, ms in g if ATTENTION.search(nm))),
        "rest_ms": med(lambda g: sum(ms for nm, ms in g
                                      if not GEMM.search(nm) and not ATTENTION.search(nm))),
        "top": [[name[:100], c / n, ms / n] for name, (c, ms) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    for p in (str(root), str(root / "src")):
        sys.path.insert(0, p)
    import torch

    from tierbench import harness, run
    from tierbench import trace as trace_mod

    if not torch.cuda.is_available():
        print("step_kernel_count: needs a CUDA card", file=sys.stderr)
        return 2
    seen = {}
    read = trace_mod.read

    def read_and_count(path):
        with open(path) as f:
            events = json.load(f)
        seen.update(summary(replays(events.get("traceEvents", events)
                                    if isinstance(events, dict) else events)))
        return read(path)

    trace_mod.read = read_and_count
    cell = harness.load_cell(args.workload)
    res = harness.run_cell(cell, args.seed, args.seconds, True, "cuda:0", T_START)
    line = {"workload": args.workload, "seed": args.seed, "root": str(root), "card": run.card(),
            "correct": bool(res.correct), "slice_steps": res.slice_steps, **seen}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
