"""Find a cell's knee on the card: the highest Poisson rate at which the
queue does not grow over a window.

    python tierbench/sweep.py --workload <cell> --rates 0.4,0.6,1.2 --seconds 51

One engine, set up and warmed once; for each rate, the cell's traffic at
that rate for ``--seconds`` (a run's window) after ``warm_s``, then the
slots drain. Per rate it prints the requests completed per second, the
backlog (requests due and not started) at the window's open and close and
its mean over the window's first and last thirds, the tokens served per
second, the 95th percentile of the time to first token, and the fullest the
warm pool got. The knee is where the completed rate stops following the
offered one and the backlog grows over the window; a cell's ``rate_rps``
offers about twice it.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from tierbench import harness, traffic, weights
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    conf, c = cell.conf, cell.cell
    build.build_all()
    params = weights.make(conf, args.seed, "cuda:0")
    eng = harness.build_engine(conf, c, params, "cuda:0")
    harness.warm_up(eng, cell.mix, conf, args.seed)
    costs = harness.page_costs(conf)
    warm = float(c["warm_s"])
    for rate in (float(r) for r in args.rates.split(",")):
        arrivals = traffic.schedule(cell.mix, rate, warm + args.seconds, args.seed,
                                    conf["vocab_size"], int(c["max_seq_len"]))
        t0 = time.perf_counter()
        drv = harness.Driver(eng, arrivals, t0, costs, record_hot=False)
        backlog, warm_used = [], []
        alloc = eng.cache._alloc["warm"]

        def sample():
            now = time.perf_counter()
            due = sum(1 for a in arrivals if t0 + a.due <= now)
            backlog.append((now - t0, due - len(drv.recs)))
            warm_used.append(alloc.used / alloc.capacity)

        ws, we = t0 + warm, t0 + warm + args.seconds
        drv.run(stop_at=we, on_step=sample)
        e2e = harness.end_to_end(drv, ws, we)
        done = sum(1 for r in drv.recs if r.t_done is not None and ws <= r.t_done < we)
        win = [(x, b) for x, b in backlog if warm <= x < warm + args.seconds]
        third = max(len(win) // 3, 1)
        row = {"rate": rate, "completed_per_s": done / args.seconds,
               "backlog_first_third": float(np.mean([b for _, b in win[:third]])),
               "backlog_last_third": float(np.mean([b for _, b in win[-third:]])),
               "backlog_open": drv.backlog(ws), "backlog_close": drv.backlog(we),
               **{k: v for k, v in e2e.items() if not k.startswith("_")},
               "attempted": e2e["_attempted"], "warm_used_max": max(warm_used, default=0.0)}
        print(json.dumps(row), flush=True)
        while any(s is not None for s in eng.slots):  # drain before the next rate
            eng.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
