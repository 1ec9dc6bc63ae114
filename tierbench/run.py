"""Run one cell of the benchmark once and print its result line.

    python tierbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (loading, the kernels' build on a
checkout's first run, weights from the seed on the card, the engine, the
warm-up of every shape the traffic uses) counts as ``setup_s``; then the
cell's open-loop traffic runs, its window opens ``warm_s`` later and lasts
``--seconds``. ``--trace 0`` prints the end-to-end metrics, ``--trace 1`` the
per-layer ones, read in part from a profiled slice after the window. Every
run checks what the window served against the plain reference (see
``harness.run_cell``) and prints each number compared beside its limit,
last on standard error and last in the result line.

Needs a CUDA card: without one it exits with 2 and prints no result. It
exits with 3, and no result, if JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from tierbench import harness

    cell = harness.load_cell(args.workload)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"tierbench: {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = loaded_forbidden()
    if found:
        print(f"tierbench: loaded {found}; the benchmark runs without JAX", file=sys.stderr)
        return 3

    e2e = res.e2e
    drv = res.drv
    print(f"card: {card()} (peaks at 700 W: {harness.peaks.BF16_FLOPS:.3g} FLOP/s bf16, "
          f"{harness.peaks.HBM_BYTES_PER_S:.3g} B/s)", file=sys.stderr)
    b_open, b_close = e2e["_backlog"]
    print(f"setup_s {res.setup_s:.3f} (kernel build {res.build_s:.3f}); requests due in window "
          f"{e2e['_attempted']}, tokens {e2e['_tokens_in_window']}, tier windows "
          f"{e2e['_boundaries']}; started {len(drv.recs)}, arrivals {len(drv.arrivals)}, "
          f"idle-wait oversleep max {drv.late_s * 1e3:.3f} ms", file=sys.stderr)
    print(f"backlog (due, not started) at the window's open {b_open}, at its close {b_close}; "
          f"not judged (the cell is offered more than it serves): ttft p95 "
          f"{e2e['ttft_p95_ms']} ms, tpot p95 {e2e['tpot_p95_ms']} ms", file=sys.stderr)
    if args.trace:
        metrics = harness.per_layer(res)
    else:
        metrics = {"setup_s": {"value": res.setup_s, "unit": "s"}}
        for spec in cell.manifest["end_to_end"]:
            name = spec["name"]
            if "workloads" in spec and args.workload not in spec["workloads"]:
                continue
            if name in e2e and e2e[name] is not None:
                metrics[name] = {"value": e2e[name], "unit": spec["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": need,
              "memory_peak_bytes": int(res.peak_bytes)}
    line = {"correct": bool(res.correct), "attempted": int(e2e["_attempted"]), "failed": 0,
            "metrics": metrics, "device": device}
    if args.trace and res.trace is not None:
        device["busy_s"] = res.trace.busy_s()
        device["window_s"] = res.trace.window_s
        line["breakdown"] = {"device_ops": res.trace.top_ops(), "idle_gaps": res.trace.idle_gaps()}
    for g in res.gaps:
        print(f"sampled request: {g['tokens']} served tokens, widest logit gap {g['gap']!r}, "
              f"mean {g['gap_sum'] / g['tokens']!r}; page-mass distance widest "
              f"{g.get('hot_max')!r} over {g.get('hot_rows', 0)} step-layers", file=sys.stderr)
    print(f"check over {len(res.gaps)} requests took {res.check_s:.3f} s", file=sys.stderr)
    line["checks"] = res.checks
    for name, c in res.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
