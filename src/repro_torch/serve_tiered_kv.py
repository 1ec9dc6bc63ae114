"""End-to-end serving example of the port, after
``examples/serve_tiered_kv.py``: batched requests through the tiered-KV
engine.

The engine decodes against software-defined compressed KV tiers (warm int8 /
cold int4 device pools + host tiers), with per-page attention-mass telemetry
feeding the TierScape analytical placement model every window. Prints the
paper's metrics: TCO savings, placement distribution, migrations, daemon tax.

The flags and defaults are the reference's; ``--device`` (default ``cuda``)
picks the card or, with ``cpu``, the CPU. ``main`` serves the arch's SMOKE
config, as the reference does; ``run`` takes any config.

    PYTHONPATH=src python -m repro_torch.serve_tiered_kv --requests 4
    PYTHONPATH=src python -m repro_torch.serve_tiered_kv --device cpu --requests 4
"""

import argparse
import time

import numpy as np

import repro_torch.configs as configs
from repro_torch.configs.base import TierScapeRunConfig
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving import TieredEngine
from repro_torch.serving.kv_cache import COLD, HOST4, HOST8, WARM


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2_1_2b",
                    help="any smoke arch with attention")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=0.3,
                    help="TierScape knob: 1=perf, 0=max TCO savings")
    ap.add_argument("--policy", default="analytical",
                    choices=["analytical", "waterfall"])
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--serial-migration", action="store_true",
                    help="opt back into blocking window boundaries (async "
                         "overlapped migration is the default; this runs "
                         "the serial equivalence oracle instead)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable speculative staging of warming host pages "
                         "(prefetch is the default; it is a no-op anyway with "
                         "--serial-migration)")
    ap.add_argument("--vary-prompts", action="store_true",
                    help="submit unequal prompt lengths (per-slot decode)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(cfg, args, device="cuda", params=None, log=print):
    """Serve ``args.requests`` requests of ``cfg`` and print the reference's
    lines through ``log``. ``params`` defaults to ``Model.init(0)``.
    Returns (stats, requests, engine, wall seconds)."""
    dev = resolve_device(device)
    prefetch = not args.no_prefetch and not args.serial_migration
    model = Model(cfg, device=dev)
    if params is None:
        params = model.init(0)
    eng = TieredEngine(
        model, params,
        batch_slots=args.slots, page_tokens=8,
        max_seq_len=args.prompt_len + args.new_tokens + 32,
        recent_window=16,
        ts=TierScapeRunConfig(enabled=True, policy=args.policy,
                              alpha=args.alpha, window_steps=8,
                              async_migration=not args.serial_migration,
                              prefetch=prefetch),
        device=dev,
    )

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = args.prompt_len
        if args.vary_prompts:  # per-slot lengths: each request its own size
            plen = max(args.prompt_len - 8 * (i % args.slots), 8)
        reqs.append(eng.submit(rng.integers(1, cfg.vocab_size, plen),
                               max_new_tokens=args.new_tokens))

    t0 = time.time()
    stats = eng.run(max_steps=args.requests * args.new_tokens * 2)
    wall = time.time() - t0

    log(f"arch={args.arch} policy={args.policy} alpha={args.alpha}")
    log(f"completed {stats.completed}/{args.requests} requests in "
        f"{stats.steps} engine steps ({wall:.1f}s wall)")
    log(f"windows={stats.windows} migrations={stats.migrations} "
        f"daemon_s={stats.daemon_s:.2f} overlapped_steps={stats.overlapped_steps}")
    if prefetch:
        log(f"prefetch: staged={stats.prefetch_staged} "
            f"hits={stats.prefetch_hits} misses={stats.prefetch_misses}")
    log(f"attn launches: {stats.attn_launches} "
        f"({stats.attn_launches / max(stats.steps, 1):.0f}/step, fused)")
    busy = {d: round(s * 1e6, 2)
            for d, s in eng.cache.pipeline.media_busy_s().items() if s > 0}
    if busy:
        log(f"media busy (us, executed): {busy}")
    pl = eng.cache.manager.placement[eng.cache._page_exists]
    hist = np.bincount(pl, minlength=5)
    names = {0: "dram", WARM: "warm-int8-hbm", COLD: "cold-int4-hbm",
             HOST8: "host-int8", HOST4: "host-int4"}
    live = ", ".join(f"{names[i]}={hist[i]}" for i in range(5) if hist[i])
    log(f"live page placement: {live or '(all requests done; pages freed)'}")
    log(f"peak KV memory TCO savings vs uncompressed HBM: "
        f"{stats.tco_savings_pct:.1f}%")
    for r in reqs[:2]:
        log(f"req{r.rid}: {r.out_tokens[:12]}...")
    return stats, reqs, eng, wall


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    run(configs.get_smoke(args.arch), args, args.device)


if __name__ == "__main__":
    main()
