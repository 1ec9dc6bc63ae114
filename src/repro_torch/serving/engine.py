"""Serving engine: continuous batching over slots + tiered KV cache, after
``repro.serving.engine`` (dense family, serial migration).

Request lifecycle: queue -> slot assignment -> prefill (dense, then pages
compress into the warm tier) -> decode steps (tiered attention, telemetry)
-> window boundary (TierScape placement, blocking migration) -> completion
frees pages. On the GPU every decode step runs the fused CUDA attention
kernel in every layer; on the CPU it runs the plain oracle, as the JAX
engine does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import TierScapeRunConfig
from repro_torch.core.manager import ManagerConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model, _attn_layer_count
from repro_torch.runtime import serve as serve_rt
from repro_torch.serving.kv_cache import TieredKVCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    tenant: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    windows: int = 0
    migrations: int = 0
    completed: int = 0
    # Frontend preemption counters (the frontend is not ported yet; they
    # stay 0 and keep the reference's stats layout).
    preemptions: int = 0
    resumes: int = 0
    resumed_pages: int = 0
    re_prefill_tokens: int = 0
    # Async-pipeline and prefetch counters (serial migration: always 0).
    overlapped_steps: int = 0
    prefetch_staged: int = 0
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    # Decode-attention launches billed by the cache's dispatch proxy
    # (n_layers per step on the fused path).
    attn_launches: int = 0
    # Wall seconds (host clock): decode steps (kernels plus the telemetry
    # copy to the host, so device work is complete), telemetry folds plus
    # window boundaries, prefills, and window boundaries alone.
    decode_s: float = 0.0
    daemon_s: float = 0.0
    prefill_s: float = 0.0
    window_s: float = 0.0
    tco_savings_pct: float = 0.0
    completed_by_tenant: Dict[int, int] = dataclasses.field(default_factory=dict)
    tco_savings_by_tenant: Dict[int, float] = dataclasses.field(default_factory=dict)


def _check_ported(ts: TierScapeRunConfig, family: str) -> None:
    """Options of the reference engine that later slices port: each raises
    instead of running something else."""
    later = {
        "async_migration=True (the media pipeline)": ts.async_migration,
        "prefetch=True (speculative prefetch on the media pipeline)": ts.prefetch,
        "faults=True / fault_plan (fault injection)": ts.faults or ts.fault_plan is not None,
        "host_media_device (media catalog rebinding)": ts.host_media_device != "",
        f"family {family!r} (only 'dense' is ported)": family != "dense",
    }
    bad = [k for k, v in later.items() if v]
    if bad:
        raise NotImplementedError(
            "not ported yet (a later slice of the port, see ROADMAP): " + "; ".join(bad)
            + ". Pass async_migration=False, prefetch=False explicitly."
        )


class TieredEngine:
    """Single-device engine for dense archs with tiered KV."""

    def __init__(
        self,
        model: Model,
        params,
        batch_slots: int = 4,
        page_tokens: int = 16,
        max_seq_len: int = 512,
        recent_window: int = 32,
        ts: Optional[TierScapeRunConfig] = None,
        device="cuda",
    ):
        cfg = model.cfg
        self.device = resolve_device(device)
        ts = ts or TierScapeRunConfig(enabled=True)
        _check_ported(ts, cfg.family)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked for {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.bs = batch_slots
        self.pt = page_tokens
        self.recent_window = recent_window
        self.max_seq_len = max_seq_len
        self.ts = ts
        self.la = _attn_layer_count(cfg)

        mgr_cfg = ManagerConfig(
            policy=ts.policy,
            alpha=ts.alpha,
            hotness_threshold=ts.hotness_threshold,
            window_steps=ts.window_steps,
        )
        self.cache = TieredKVCache(
            cfg,
            self.la,
            batch_slots,
            page_tokens,
            max_seq_len,
            recent_window,
            mgr_cfg,
            pool_bits={"warm": ts.warm_bits, "cold": ts.cold_bits},
            device=self.device,
        )
        # The fused CUDA kernel on the GPU; the plain oracle on the CPU (the
        # JAX engine's own choice, ``use_kernels=False``).
        self._step_fn = serve_rt.make_tiered_decode_step(
            model, ts, use_kernels=self.device.type == "cuda", device=self.device
        )
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.slot_len = np.zeros(batch_slots, np.int64)
        self.queue: List[Request] = []
        self.stats = EngineStats()
        self._steps_in_window = 0
        self._next_rid = 0

    # ----------------------------------------------------------------- API
    def make_request(self, prompt: np.ndarray, max_new_tokens: int,
                     tenant: int = 0) -> Request:
        """Mint a request with a unique monotonic rid WITHOUT enqueueing it."""
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, tenant=tenant)
        self._next_rid += 1
        return req

    def submit(self, prompt: np.ndarray, max_new_tokens: int, tenant: int = 0) -> Request:
        req = self.make_request(prompt, max_new_tokens, tenant)
        self.queue.append(req)
        return req

    # ------------------------------------------------------------ stepping
    def run(self, max_steps: int = 10_000) -> EngineStats:
        while ((any(s is not None for s in self.slots) or self.queue)
               and self.stats.steps < max_steps):
            self._fill_slots()
            self.step()
        return self.finish()

    def step(self) -> None:
        """One externally-drivable engine step: decode every active slot,
        then advance the profile window."""
        self._decode_step()
        self._steps_in_window += 1
        if self._steps_in_window >= self.ts.window_steps:
            self._end_window()

    def finish(self) -> EngineStats:
        """Finalize the stats snapshot (idempotent)."""
        self.stats.tco_savings_pct = max(
            self.stats.tco_savings_pct, self.cache.tco_savings_pct()
        )
        self.stats.attn_launches = self.cache.attn_launches
        return self.stats

    def start_request(self, slot: int, req: Request) -> None:
        """Place ``req`` into a specific FREE slot and prefill it."""
        if self.slots[slot] is not None:
            raise ValueError(f"start_request: slot {slot} is occupied")
        self.cache.set_slot_tenant(slot, req.tenant)
        self._prefill(slot, req)
        self.slots[slot] = req

    # ------------------------------------------------------------ internals
    def _fill_slots(self):
        for i in range(self.bs):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.start_request(i, req)

    def _prefill(self, slot: int, req: Request):
        """Dense prefill, then page the prompt KV into the warm tier
        (batched: one quant launch for all layers x pages). The KV stays on
        the device (the reference round-trips it through host numpy)."""
        t0 = time.perf_counter()
        s = len(req.prompt)
        if req.out_tokens:
            self.stats.re_prefill_tokens += s
        dev = self.device
        batch = {"tokens": torch.as_tensor(req.prompt[None], dtype=torch.int64, device=dev)}
        state = self.model.init_cache(1, max(s + 1, self.pt))
        logits, state = self.model.prefill(self.params, batch, state)
        # Page out everything except the tail that fits the recent window.
        n_full_pages = max((s - self.recent_window // 2) // self.pt, 0)
        k = state.k_cache[:, 0].to(torch.float32)  # [L,S,KV,hd]
        v = state.v_cache[:, 0].to(torch.float32)
        entries = [
            (layer, slot, page)
            for layer in range(self.la) for page in range(n_full_pages)
        ]
        if entries:
            pt = self.pt
            kp = k[:, :n_full_pages * pt].reshape(self.la * n_full_pages, pt, *k.shape[2:])
            vp = v[:, :n_full_pages * pt].reshape(self.la * n_full_pages, pt, *v.shape[2:])
            self.cache.append_pages(entries, kp, vp)
        # Remaining tail into the recent window.
        tlen = s - n_full_pages * self.pt
        st = self.cache.state
        st.recent_k[:, slot, :tlen] = k[:, n_full_pages * self.pt:s].to(st.recent_k.dtype)
        st.recent_v[:, slot, :tlen] = v[:, n_full_pages * self.pt:s].to(st.recent_v.dtype)
        st.recent_len[slot] = tlen
        st.total_len[slot] = s
        self.slot_len[slot] = s
        req.out_tokens.append(int(torch.argmax(logits[0, -1])))
        self.stats.prefill_s += time.perf_counter() - t0

    def _decode_step(self):
        t0 = time.perf_counter()
        tokens = np.zeros((self.bs, 1), np.int64)
        for i, req in enumerate(self.slots):
            if req is not None and req.out_tokens:
                tokens[i, 0] = req.out_tokens[-1]
        logits, tkv, _, telemetry = self._step_fn(
            self.params, torch.as_tensor(tokens, device=self.device), self.cache.state, None
        )
        self.cache.state = tkv
        telemetry = {k: v.cpu().numpy() for k, v in telemetry.items()}
        next_tok = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        self.stats.decode_s += time.perf_counter() - t0

        t1 = time.perf_counter()
        self.cache.record_telemetry(telemetry)
        self.stats.daemon_s += time.perf_counter() - t1

        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.out_tokens.append(int(next_tok[i]))
            self.slot_len[i] += 1
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.stats.completed += 1
                self.stats.completed_by_tenant[req.tenant] = (
                    self.stats.completed_by_tenant.get(req.tenant, 0) + 1
                )
                self._release_slot(i)
        self.stats.steps += 1
        self._maybe_page_out_recent()

    def _maybe_page_out_recent(self):
        """When a slot's recent window fills, compress its oldest full
        pages. Per slot: each slot pages out at its own fill level and its
        recent rows shift by its own amount."""
        st = self.cache.state
        rl = st.recent_len.cpu().numpy()  # [B]
        full = [
            i for i, req in enumerate(self.slots)
            if req is not None and int(rl[i]) >= self.recent_window
        ]
        if not full:
            return
        k = st.recent_k.to(torch.float32)  # [L,B,R,KV,hd]
        v = st.recent_v.to(torch.float32)
        entries, src = [], []
        shift = np.zeros(self.bs, np.int64)
        for i in full:
            # Move floor(rl/pt)-1 pages out, keep the newest tokens dense
            # (n_out >= 1: the window is full, something must leave).
            n_out = max(int(rl[i]) // self.pt - 1, 1)
            shift[i] = n_out * self.pt
        for layer in range(self.la):
            for i in full:
                start_tok = int(self.slot_len[i]) - int(rl[i])
                for p in range(int(shift[i]) // self.pt):
                    entries.append((layer, i, (start_tok + p * self.pt) // self.pt))
                    src.append((layer, i, p))
        if entries:
            li = torch.as_tensor([e[0] for e in src], device=self.device)
            bi = torch.as_tensor([e[1] for e in src], device=self.device)
            pi = torch.as_tensor([e[2] for e in src], device=self.device)
            tok = pi[:, None] * self.pt + torch.arange(self.pt, device=self.device)[None]
            self.cache.append_pages(
                entries, k[li[:, None], bi[:, None], tok], v[li[:, None], bi[:, None], tok]
            )
        st = self.cache.state
        # Per-slot roll on the device: row b reads from (j + shift[b]) % R.
        r = st.recent_k.shape[2]
        idx = (torch.arange(r, device=self.device)[None, :]
               + torch.as_tensor(shift, device=self.device)[:, None]) % r  # [B, R]
        self.cache.state = dataclasses.replace(
            st,
            recent_k=st.recent_k[:, torch.arange(self.bs, device=self.device)[:, None], idx],
            recent_v=st.recent_v[:, torch.arange(self.bs, device=self.device)[:, None], idx],
            recent_len=st.recent_len - torch.as_tensor(shift, dtype=torch.int32,
                                                       device=self.device),
        )

    def _release_slot(self, slot: int):
        """Request finished: free its pages everywhere (batched)."""
        self.cache.release_slot_pages(slot)
        self.slots[slot] = None
        self.slot_len[slot] = 0
        st = self.cache.state
        st.recent_len[slot] = 0
        st.total_len[slot] = 0

    def _end_window(self):
        t0 = time.perf_counter()
        plan, moved = self.cache.end_window()
        dt = time.perf_counter() - t0
        self.stats.daemon_s += dt
        self.stats.window_s += dt
        self.stats.migrations += moved
        self.stats.windows += 1
        self._steps_in_window = 0
        # Snapshot TCO savings while pages are live (completion frees them).
        self.stats.tco_savings_pct = max(
            self.stats.tco_savings_pct, self.cache.tco_savings_pct()
        )
        for t in {r.tenant for r in self.slots if r is not None}:
            self.stats.tco_savings_by_tenant[t] = max(
                self.stats.tco_savings_by_tenant.get(t, 0.0),
                self.cache.tco_savings_pct(tenant=t),
            )
