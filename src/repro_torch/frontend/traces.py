"""Deterministic arrival traces for the serving frontend, after
``repro.frontend.traces``: the same ``TraceConfig`` gives the same events and
the same ``digest`` in both packages.

Requests arrive in VIRTUAL TIME (integer scheduler steps, one decode step
per unit) from three seeded generators:

  * ``poisson`` — constant-rate Poisson arrivals;
  * ``diurnal`` — Poisson with a sinusoidal day/night rate swing
    (``period_steps``, ``trough_frac``);
  * ``burst``   — Poisson base load plus periodic bursts
    (``burst_every``/``burst_len``/``burst_mult``), optionally pinned to one
    SLA class (``burst_sla``) — the preemption trigger.

Tenant mix can flip mid-trace (``tenant_flip_step``): the skew-flip pattern
the placement benchmarks use, expressed as arrival skew. Each event carries
its own ``prompt_seed`` so prompt token ids materialize deterministically
and independently of generation order. ``python -m repro_torch.frontend.traces
--check`` validates two-pass determinism of every kind.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import math
import sys
from typing import List, Optional, Tuple

import numpy as np

TRACE_KINDS = ("poisson", "diurnal", "burst")


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One request arrival in virtual time."""

    step: int  # arrival step (scheduler virtual time)
    seq: int  # trace order, unique — FIFO tie-break within an SLA class
    tenant: int
    sla: int  # index into the scheduler's SLA-class list
    session: int  # session id for router affinity
    prompt_len: int
    max_new_tokens: int
    prompt_seed: int

    def prompt(self, vocab_size: int) -> np.ndarray:
        """Materialize the prompt token ids (deterministic per event)."""
        rng = np.random.default_rng(self.prompt_seed)
        return rng.integers(1, vocab_size, size=self.prompt_len).astype(np.int32)

    def key(self) -> Tuple[int, ...]:
        return (self.step, self.seq, self.tenant, self.sla, self.session,
                self.prompt_len, self.max_new_tokens, self.prompt_seed)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    kind: str = "poisson"
    steps: int = 128
    rate: float = 0.25  # mean arrivals per step (base load)
    seed: int = 0
    n_tenants: int = 2
    n_sessions: int = 8
    sla_mix: Tuple[float, ...] = (0.7, 0.3)  # arrival weight per SLA class
    prompt_len: Tuple[int, int] = (16, 32)  # inclusive range
    new_tokens: Tuple[int, int] = (8, 24)  # inclusive range
    # Tenant skew (weights over tenant ids); reversed after tenant_flip_step.
    tenant_mix: Optional[Tuple[float, ...]] = None
    tenant_flip_step: Optional[int] = None
    # diurnal
    period_steps: int = 64
    trough_frac: float = 0.2  # trough rate as a fraction of the peak
    # burst
    burst_every: int = 48
    burst_len: int = 6
    burst_mult: float = 6.0
    burst_sla: Optional[int] = None  # pin burst arrivals to one SLA class


def rate_at(cfg: TraceConfig, step: int) -> float:
    """Instantaneous arrival rate at ``step`` (virtual time)."""
    if cfg.kind == "poisson":
        return cfg.rate
    if cfg.kind == "diurnal":
        # Peak at cfg.rate, trough at trough_frac * rate, sinusoidal.
        lo = cfg.trough_frac * cfg.rate
        phase = 2.0 * math.pi * (step % cfg.period_steps) / cfg.period_steps
        return lo + (cfg.rate - lo) * 0.5 * (1.0 + math.cos(phase))
    if cfg.kind == "burst":
        base = cfg.rate
        if (step % cfg.burst_every) < cfg.burst_len:
            return base * cfg.burst_mult
        return base
    raise ValueError(f"unknown trace kind {cfg.kind!r} (want one of {TRACE_KINDS})")


def _in_burst(cfg: TraceConfig, step: int) -> bool:
    return cfg.kind == "burst" and (step % cfg.burst_every) < cfg.burst_len


def generate(cfg: TraceConfig) -> List[ArrivalEvent]:
    """Generate the full arrival trace (sorted by (step, seq)). Stateless:
    the same config always yields the same events, byte for byte."""
    if cfg.kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {cfg.kind!r} (want one of {TRACE_KINDS})")
    rng = np.random.default_rng(cfg.seed)
    sla_p = np.asarray(cfg.sla_mix, np.float64)
    sla_p = sla_p / sla_p.sum()
    ten_p = None
    if cfg.tenant_mix is not None:
        ten_p = np.asarray(cfg.tenant_mix, np.float64)
        if ten_p.size != cfg.n_tenants:
            raise ValueError("tenant_mix must have one weight per tenant")
        ten_p = ten_p / ten_p.sum()
    events: List[ArrivalEvent] = []
    seq = 0
    for step in range(cfg.steps):
        n = int(rng.poisson(rate_at(cfg, step)))
        for _ in range(n):
            if cfg.burst_sla is not None and _in_burst(cfg, step):
                sla = int(cfg.burst_sla)
            else:
                sla = int(rng.choice(sla_p.size, p=sla_p))
            if ten_p is None:
                tenant = int(rng.integers(cfg.n_tenants))
            else:
                p = ten_p
                if cfg.tenant_flip_step is not None and step >= cfg.tenant_flip_step:
                    p = ten_p[::-1]
                tenant = int(rng.choice(cfg.n_tenants, p=p))
            events.append(ArrivalEvent(
                step=step,
                seq=seq,
                tenant=tenant,
                sla=sla,
                session=int(rng.integers(cfg.n_sessions)),
                prompt_len=int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1)),
                max_new_tokens=int(rng.integers(cfg.new_tokens[0], cfg.new_tokens[1] + 1)),
                prompt_seed=int(rng.integers(2**31 - 1)),
            ))
            seq += 1
    return events


def digest(events: List[ArrivalEvent]) -> str:
    """Canonical sha256 over the full event stream (replay fingerprint)."""
    h = hashlib.sha256()
    for e in events:
        h.update(repr(e.key()).encode())
    return h.hexdigest()


def check(seeds: Tuple[int, ...] = (0, 1)) -> int:
    """Trace-determinism smoke: every kind x seed
    must regenerate bit-identically (fresh RNGs both times), stay sorted in
    virtual time, and produce deterministic prompt token ids."""
    failures = 0
    for kind in TRACE_KINDS:
        for seed in seeds:
            cfg = TraceConfig(
                kind=kind, seed=seed, steps=96, rate=0.5,
                tenant_mix=(0.8, 0.2), tenant_flip_step=48,
                burst_sla=1,
            )
            a, b = generate(cfg), generate(cfg)
            da, db = digest(a), digest(b)
            ok = (
                da == db
                and len(a) > 0
                and all(x.key() == y.key() for x, y in zip(a, b))
                and all(a[i].step <= a[i + 1].step for i in range(len(a) - 1))
                and all(a[i].seq == i for i in range(len(a)))
                and np.array_equal(a[0].prompt(256), b[0].prompt(256))
            )
            status = "ok" if ok else "MISMATCH"
            print(f"  {kind:8s} seed={seed} events={len(a):4d} {da[:16]} {status}")
            if not ok:
                failures += 1
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", action="store_true",
                    help="validate two-pass trace determinism")
    ap.add_argument("--kind", default="poisson", choices=TRACE_KINDS)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--rate", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.check:
        print("trace determinism check:")
        failures = check()
        print("PASS" if failures == 0 else f"FAIL ({failures} mismatches)")
        return 1 if failures else 0
    cfg = TraceConfig(kind=args.kind, steps=args.steps, rate=args.rate, seed=args.seed)
    ev = generate(cfg)
    print(f"{cfg.kind} trace: {len(ev)} arrivals over {cfg.steps} steps "
          f"(digest {digest(ev)[:16]})")
    for e in ev[:10]:
        print(f"  step={e.step:4d} seq={e.seq:4d} tenant={e.tenant} sla={e.sla} "
              f"session={e.session} prompt={e.prompt_len} gen={e.max_new_tokens}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
