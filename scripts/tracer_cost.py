"""Host cost of the engine's tracer (``repro_torch.tracing``) per decode step.

    PYTHONPATH=src python scripts/tracer_cost.py [--steps N] [--out PATH]

Replays the records of one engine step with a tier-window boundary in it,
13 spans nested as the engine opens them and one counter, ``--steps`` times:
with no profiler active, then inside ``torch.profiler.profile`` (CPU
activity, and CUDA activity where a card is present). Prints one JSON line:
microseconds a step for each, the same loop with no tracer, and the card
and its power limit where there is one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import tracing  # noqa: E402

STEP = ("engine.step", [
    ("engine.decode", [("engine.decode.wait", [])]),
    ("cache.fold_telemetry", []),
    ("pipeline.tick", [("pipeline.stage", []), ("pipeline.busy_ticks", None)]),
    ("engine.release", []),
    ("engine.page_out", []),
    ("engine.window", [("cache.drain", []), ("cache.policy", []),
                       ("cache.submit", [("prefetch.hits", None)])]),
])
RECORDS = 15


def replay(tr, node) -> None:
    name, children = node
    if children is None:
        tr.count(name)
        return
    with tr.span(name):
        for c in children:
            replay(tr, c)


def bare(node) -> None:
    for c in node[1] or ():
        bare(c)


def per_step_us(fn, steps: int) -> float:
    t = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t) / steps * 1e6


def card() -> str:
    if not torch.cuda.is_available():
        return "none"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tr = tracing.Tracer()

    def traced():
        tr.step += 1
        replay(tr, STEP)

    per_step_us(traced, 1000)  # warm
    out = {"records_per_step": RECORDS, "steps": args.steps,
           "bare_us": per_step_us(lambda: bare(STEP), args.steps),
           "traced_us": per_step_us(traced, args.steps)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    n = max(args.steps // 10, 1)
    with torch.profiler.profile(activities=acts):
        out["profiled_us"] = per_step_us(traced, n)
    out["profiled_steps"] = n
    out["card"] = card()
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
