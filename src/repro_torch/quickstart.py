"""Quickstart: TierScape in two minutes, on the port's control plane.

1. Characterize the 12 software-defined compressed tiers (codec x pool x
   media) — the paper's Fig. 3.
2. Run the window simulator: DRAM + 1 compressed tier (the 2-Tier
   state-of-the-art) vs DRAM + 5 tiers under waterfall and analytical
   placement — the paper's Fig. 8 headline.

Host-only numpy (no GPU needed); prints the same lines as the JAX package's
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart
"""

from repro_torch.core import simulator, tiers
from repro_torch.core.manager import make_manager

REGION = 1 << 20  # 2MB region / 2B per element


def main() -> None:
    print("== The 12 characterized software-defined compressed tiers ==")
    print(f"{'id':4s} {'name':10s} {'ratio':>6s} {'lat(2MB) us':>12s} {'USD/GB':>7s}")
    for t in tiers.characterized():
        print(
            f"{t.tid:4s} {t.name:10s} {t.effective_ratio(REGION):6.2f} "
            f"{t.access_latency_s(REGION) * 1e6:12.1f} "
            f"{t.usd_per_source_byte(REGION) * (1 << 30):7.2f}"
        )
    print("\nselected (paper Table 2 analogue):",
          ", ".join(t.tid + ":" + t.name for t in tiers.selected()))

    print("\n== 2-Tier vs TierScape on a Memcached-like workload ==")
    wl = simulator.gaussian_kv(n_regions=2048, accesses_per_window=500_000)
    thresholds = {"C": 50.0, "M": 200.0, "A": 800.0}
    print(f"{'config':12s} {'slowdown %':>10s} {'TCO saved %':>11s} {'p99 us':>8s} {'tax %':>6s}")
    for cfg in ("2T-C", "2T-M", "2T-A", "6T-WF-C", "6T-WF-M", "6T-WF-A",
                "6T-AM-0.9", "6T-AM-0.5", "6T-AM-0.1"):
        mgr = make_manager(cfg, wl.n_regions, thresholds=thresholds)
        r = simulator.simulate(wl, mgr, windows=20, seed=1)
        print(f"{cfg:12s} {r.slowdown_pct:10.2f} {r.tco_savings_pct:11.2f} "
              f"{r.p99_access_us:8.2f} {r.daemon_tax_pct:6.2f}")
    print("\nN-Tier saves 10-20pp more memory TCO than 2-Tier at equal or "
          "better slowdown — the paper's Fig. 8 claim.")


if __name__ == "__main__":
    main()
