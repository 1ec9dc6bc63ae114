"""Decode time of the tiered engine on a GPU, for one copy of the port's
package, so that two trees (one whose engine replays a captured CUDA graph
of the step, one whose engine runs it eagerly) can be compared in one call.

    python scripts/graph_step_times.py                       # this checkout
    python scripts/graph_step_times.py --src OTHER/src --label parent

It imports ``repro_torch`` from ``--src`` (this checkout's ``src`` by
default) and, per configuration, builds the engine of ``chip_smoke.py``'s
default path (2 slots, 16-token pages, a 32-token recent window, 1024-token
sequences, async migration + prefetch at alpha 0.1, 16-step windows; the
hybrid's host tiers on ``cxl_hw``) on random bf16 weights from seed 0:
``qwen1_5_4b`` and ``zamba2_1_2b`` at full width and depth, ``qwen3_32b`` at
32 of 64 layers and ``qwen3_moe_235b`` at 8 of 94 (full width). Two
requests are prefilled, then ``STEPS`` engine steps are driven (three
window boundaries with their migrations, page-outs on the way). Reported
per configuration: decode ms/step (the engine's host clock, which ends in
the telemetry copy to the host; over all steps, and over the steps after
the first, which on a capturing tree holds the warm-up and the capture),
tokens/s of the decode loop (generated tokens over its wall time), peak
device memory above the weights and the captures; with ``--profile`` also a
profile of ``PROFILE_STEPS`` more engine steps under ``torch.profiler``
(device time summed over the device's own events, and its share of the host
wall time). Once the profiler has run, every later launch in the process
costs more host time, so times are taken from runs without ``--profile``.
Prints one JSON line (and writes it to ``build/graph_step_times/<label>.json``),
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (arch, layers or None for full depth, prompt lengths, host media device)
CONFIGS = (("qwen1_5_4b", None, (400, 500), ""),
           ("zamba2_1_2b", None, (96, 128), "cxl_hw"),
           ("qwen3_32b", 32, (400, 500), ""),
           ("qwen3_moe_235b", 8, (400, 500), ""))
STEPS, PROFILE_STEPS = 48, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--profile", action="store_true",
                    help="also profile PROFILE_STEPS more steps of each engine")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TierScapeRunConfig, get
    from repro_torch.models import Model
    from repro_torch.serving.engine import TieredEngine

    if not torch.cuda.is_available():
        print("graph_step_times: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = {"label": args.label, "src": args.src, "card": card, "steps": STEPS}
    for arch, layers, prompts, media in CONFIGS:
        cfg = get(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = Model(cfg)
        params = model.init(0)
        torch.cuda.synchronize()
        weights = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ts = TierScapeRunConfig(enabled=True, alpha=0.1, window_steps=16, async_migration=True,
                                prefetch=True, faults=False, host_media_device=media)
        eng = TieredEngine(model, params, batch_slots=2, page_tokens=16, max_seq_len=1024,
                           recent_window=32, ts=ts)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(1, cfg.vocab_size, n),
                           max_new_tokens=STEPS + PROFILE_STEPS + 2) for n in prompts]
        eng._fill_slots()
        torch.cuda.synchronize()
        tok0 = sum(len(r.out_tokens) for r in reqs)
        t0 = time.perf_counter()
        eng.step()
        first_s = eng.stats.decode_s
        for _ in range(STEPS - 1):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gen = sum(len(r.out_tokens) for r in reqs) - tok0
        row = {"layers": cfg.n_layers, "prompts": list(prompts),
               "decode_ms_per_step": eng.stats.decode_s / STEPS * 1e3,
               "decode_ms_per_step_after_first": (eng.stats.decode_s - first_s) / (STEPS - 1) * 1e3,
               "first_step_ms": first_s * 1e3,
               "tokens_per_s": gen / wall, "loop_wall_s": wall,
               "windows": eng.stats.windows, "migrations": eng.stats.migrations,
               "peak_above_weights_bytes": torch.cuda.max_memory_allocated() - weights,
               "captures": dict(getattr(eng._step_fn, "captures", {})),
               "capture_s": getattr(eng._step_fn, "capture_s", None)}
        if args.profile:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILE_STEPS):
                    eng.step()
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
            device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA) / 1e3 / PROFILE_STEPS
            row.update({"profiled_step_ms": step_ms, "profiled_device_ms": device_ms,
                        "device_busy_share": device_ms / step_ms})
            del prof
        out[arch] = row
        print(f"{args.label} {arch}: {json.dumps(row)}", flush=True)
        del eng, reqs, params, model
        gc.collect()
        torch.cuda.empty_cache()
    line = json.dumps(out)
    dest = ROOT / "build" / "graph_step_times"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.label}.json").write_text(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
