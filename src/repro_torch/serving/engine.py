"""Serving engine: continuous batching over slots + tiered KV cache, after
``repro.serving.engine`` (the dense, MoE, VLM and hybrid families).

Request lifecycle: queue -> slot assignment -> prefill (dense, then pages
compress into the warm tier) -> decode steps (tiered attention, telemetry,
one migration-pipeline tick or speculative prefetch tick) -> window boundary
(TierScape placement; the plan's cohorts go to the async media pipeline by
default, or run to completion with ``async_migration=False``) -> completion
frees pages. Each phase is a span of the engine's ``tracing.Tracer``
(``engine.step``, ``engine.decode``, ``engine.window``, ...), keyed by
engine step; ``EngineStats``' clocks are sums of those spans.
``faults``/``fault_plan`` arm deterministic media fault injection and
``host_media_device`` rebinds the host tiers (on ``cxl_hw`` the HOST8 pages
read back through the ``cxl_decode_pages`` kernel). On the
GPU every decode step runs the fused CUDA attention kernel in every
attention layer (or, under ``ops.use_fused(False)``, one per-pool kernel per
pool), the whole step captured once as a CUDA graph and replayed per token
(``runtime.graph.GraphedStep``, the counterpart of the JAX engine's jitted
step); on the CPU the same step runs eagerly on the kernels' plain versions
(the wrappers choose by the tensors' device). A hybrid
arch (Zamba2) also carries each slot's SSM side state (conv, ssm) through
the decode steps; its prefill reuses the SSM states ``Model.prefill``
computes (the reference engine scans the prompt a second time for them, and
gets the same values). A MoE arch prefills each prompt as one dispatch group
(capacity drops happen there, never at decode); a VLM arch serves text
prompts, its M-RoPE at each slot's own position. An attention-free model
(the SSM family) has no KV to tier and is refused, as the reference refuses
it; so is an encoder, which has no decode.

The serving frontend (``repro_torch.frontend``) drives the engine slot by
slot: ``start_request`` into a chosen free slot, ``step``, and
preemption-to-host-tier: ``preempt_slot`` demotes the slot's device pages to
their same-codec host tiers and parks them (with the hybrid's SSM side
state) as a ``PreemptedRequest``; ``resume_into`` restores it into any free
slot of any engine of the same geometry with zero re-prefilled tokens.
Token accounting (``token_capacity``, ``outstanding_tokens``,
``device_headroom_tokens``) feeds its admission control.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import TierScapeRunConfig
from repro_torch.core.manager import ManagerConfig
from repro_torch.device import resolve_device
from repro_torch.media.faults import default_plan
from repro_torch.models.transformer import Model, _attn_layer_count, ssm_state_shapes
from repro_torch.runtime import serve as serve_rt
from repro_torch.runtime.graph import GraphedStep
from repro_torch.runtime.serve import check_tiered
from repro_torch.serving.kv_cache import ParkedSlot, TieredKVCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    tenant: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class PreemptedRequest:
    """A request evicted from its batch slot with its KV parked on the host
    tier (plus, for the hybrid, host copies of its SSM side state).
    ``TieredEngine.resume_into`` swaps it back in with zero re-prefilled
    tokens."""

    request: Request
    parked: ParkedSlot
    ssm_conv: Optional[torch.Tensor] = None  # [L_ssm, K-1, C] bf16, host
    ssm_state: Optional[torch.Tensor] = None  # [L_ssm, H, P, N] f32, host


# The spans, as (parent, name), that each of ``EngineStats``' clocks sums:
# decode steps (kernels plus the telemetry and argmax copies to the host, so
# device work is complete), prefills, window boundaries, and the daemon:
# telemetry folds, pipeline or prefetch ticks, boundaries and the drain in
# ``finish``.
_STEP = "engine.step"
CLOCKS = {
    "decode_s": ((_STEP, "engine.decode"),),
    "prefill_s": ((None, "engine.prefill"),),
    "window_s": ((_STEP, "engine.window"),),
    "daemon_s": ((_STEP, "cache.fold_telemetry"), (_STEP, "pipeline.tick"),
                 (_STEP, "cache.prefetch_tick"), (_STEP, "engine.window"),
                 (None, "engine.finish")),
}


@dataclasses.dataclass
class EngineStats:
    # The engine's cache: the prefetch and launch counts below read it and
    # its pipeline, the clocks its tracer.
    cache: TieredKVCache = dataclasses.field(repr=False, compare=False)
    steps: int = 0
    windows: int = 0
    migrations: int = 0
    completed: int = 0
    # Preemption to the host tier: slots vacated for a higher-SLA arrival,
    # requests swapped back in from parked host pages, pages restored by
    # those swap-ins, and prompt tokens re-prefilled for an already-started
    # request (the frontend keeps this at 0: resume restores pages instead
    # of recomputing them).
    preemptions: int = 0
    resumes: int = 0
    resumed_pages: int = 0
    re_prefill_tokens: int = 0
    # Decode steps retired while a migration cohort was in flight (async
    # pipeline).
    overlapped_steps: int = 0
    tco_savings_pct: float = 0.0
    completed_by_tenant: Dict[int, int] = dataclasses.field(default_factory=dict)
    tco_savings_by_tenant: Dict[int, float] = dataclasses.field(default_factory=dict)

    # Speculative prefetch: pages staged / claimed / missed.
    @property
    def prefetch_staged(self) -> int:
        return self.cache.pipeline.prefetch_staged

    @property
    def prefetch_hits(self) -> int:
        return self.cache.pipeline.prefetch_hits

    @property
    def prefetch_misses(self) -> int:
        return self.cache.pipeline.prefetch_misses

    @property
    def attn_launches(self) -> int:
        """Decode-attention launches billed by the cache's dispatch proxy
        (fused: n_layers per step; per-pool: n_layers * n_pools)."""
        return self.cache.attn_launches

    # Wall seconds on the host clock (``CLOCKS``).
    @property
    def decode_s(self) -> float:
        return self.cache.tracer.seconds(CLOCKS["decode_s"])

    @property
    def daemon_s(self) -> float:
        return self.cache.tracer.seconds(CLOCKS["daemon_s"])

    @property
    def prefill_s(self) -> float:
        return self.cache.tracer.seconds(CLOCKS["prefill_s"])

    @property
    def window_s(self) -> float:
        return self.cache.tracer.seconds(CLOCKS["window_s"])


class TieredEngine:
    """Single-device engine for the attention decoders and hybrid archs
    with tiered KV."""

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
        # No KV to tier: an attention-free model (refused as the reference
        # refuses it) or an encoder (the reference accepts it and fails in
        # prefill; ROADMAP §3).
        check_tiered(cfg)
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
        self.tracer = tracing.Tracer()
        tracing.set_current(self.tracer)
        fault_plan = ts.fault_plan
        if fault_plan is None and ts.faults:
            # Chaos soak: the default transient + corruption plan on the host
            # media device — fully recovered and billing-neutral.
            fault_plan = default_plan(ts.host_media_device or "host_dram_pcie")
        self.cache = TieredKVCache(
            cfg,
            self.la,
            batch_slots,
            page_tokens,
            max_seq_len,
            recent_window,
            mgr_cfg,
            async_migration=ts.async_migration,
            ring_slots=ts.media_ring_slots,
            prefetch=ts.prefetch,
            prefetch_max_pages=ts.prefetch_max_pages,
            pool_bits={"warm": ts.warm_bits, "cold": ts.cold_bits},
            host_media_device=ts.host_media_device,
            fault_plan=fault_plan,
            device=self.device,
            tracer=self.tracer,
        )
        # One step body on every device: on the GPU its wrappers launch the
        # kernels, and the step is captured once as a CUDA graph and replayed
        # per token, as the JAX engine jits it; on the CPU the same body runs
        # eagerly on the kernels' plain versions.
        step = serve_rt.make_tiered_decode_step(model, ts, device=self.device)
        on_gpu = self.device.type == "cuda"
        self._step_fn = GraphedStep(step, self.device) if on_gpu else step
        # SSM side state of a hybrid arch: (conv bf16, ssm f32) per layer
        # and slot; None for the dense family.
        self.ssm_state = None
        if cfg.family == "hybrid":
            conv_shape, ssm_shape = ssm_state_shapes(cfg, batch_slots)
            self.ssm_state = (
                torch.zeros(conv_shape, dtype=torch.bfloat16, device=self.device),
                torch.zeros(ssm_shape, dtype=torch.float32, device=self.device),
            )
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.slot_len = np.zeros(batch_slots, np.int64)
        self.queue: List[Request] = []
        self.stats = EngineStats(self.cache)
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

    def try_submit(self, prompt: np.ndarray, max_new_tokens: int,
                   tenant: int = 0, budget_frac: float = 1.0) -> Optional[Request]:
        """Token-budget admission: enqueue only if the projected footprint
        (prompt + full generation) fits inside ``budget_frac`` of the device
        pools' token capacity beside everything already outstanding.
        Returns None (refused) instead of overcommitting."""
        projected = int(len(prompt)) + int(max_new_tokens)
        if self.outstanding_tokens() + projected > budget_frac * self.token_capacity():
            return None
        return self.submit(prompt, max_new_tokens, tenant)

    # ------------------------------------------------- headroom accounting
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def token_capacity(self) -> int:
        """Sequence-token capacity of the device pools plus the dense recent
        windows (a class row stores one page of ONE layer, so pool rows
        divide by the attention layer count)."""
        rows = self._alloc_capacity("warm") + self._alloc_capacity("cold")
        return (rows // self.la) * self.pt + self.bs * self.recent_window

    def _alloc_capacity(self, pool: str) -> int:
        return int(self.cache._alloc[pool].capacity)

    def device_headroom_tokens(self) -> int:
        """Live device-tier headroom in sequence tokens (free class rows of
        both pools, layer-divided): admission's immediate-placement signal."""
        free = len(self.cache._free_warm) + len(self.cache._free_cold)
        return (free // self.la) * self.pt

    def outstanding_tokens(self) -> int:
        """Tokens the engine is already committed to: resident context plus
        the ungenerated remainder of active requests, plus the full
        projected footprint of everything still queued."""
        out = 0
        for i, req in enumerate(self.slots):
            if req is not None:
                out += int(self.slot_len[i])
                out += max(req.max_new_tokens - len(req.out_tokens), 0)
        for req in self.queue:
            out += len(req.prompt) + req.max_new_tokens
        return out

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
        self.tracer.step = self.stats.steps
        with self.tracer.span(_STEP):
            self._decode_step()
            self._steps_in_window += 1
            if self._steps_in_window >= self.ts.window_steps:
                self._end_window()

    def finish(self) -> EngineStats:
        """Drain in-flight cohorts and finalize the stats snapshot
        (idempotent)."""
        self.tracer.step = self.stats.steps
        with self.tracer.span("engine.finish"):
            self.cache.drain_migrations()
        self.stats.tco_savings_pct = max(
            self.stats.tco_savings_pct, self.cache.tco_savings_pct()
        )
        return self.stats

    def start_request(self, slot: int, req: Request) -> None:
        """Place ``req`` into a specific FREE slot and prefill it."""
        if self.slots[slot] is not None:
            raise ValueError(f"start_request: slot {slot} is occupied")
        self.tracer.step = self.stats.steps
        self.cache.set_slot_tenant(slot, req.tenant)
        self._prefill(slot, req)
        self.slots[slot] = req

    def preempt_slot(self, slot: int) -> PreemptedRequest:
        """Preemption to the host tier: demote the slot's device pages to
        their same-codec host tiers through the media pipeline (billed like
        normal demotions), park the payloads and recent window, and vacate
        the slot. The request keeps its pages: ``resume_into`` restores them
        with zero re-prefilled tokens."""
        req = self.slots[slot]
        if req is None or req.done:
            raise ValueError(f"preempt_slot: slot {slot} has no active request")
        levels = self.cache.demote_slot_to_host(slot)
        parked = self.cache.park_slot(slot, restore_levels=levels)
        pre = PreemptedRequest(request=req, parked=parked)
        if self.cfg.family == "hybrid":
            conv, sst = self.ssm_state
            pre.ssm_conv = conv[:, slot].to("cpu", copy=True)
            pre.ssm_state = sst[:, slot].to("cpu", copy=True)
        self.slots[slot] = None
        self.slot_len[slot] = 0
        self.stats.preemptions += 1
        return pre

    def resume_into(self, slot: int, pre: PreemptedRequest) -> Request:
        """Swap a preempted request back into a free slot (of this engine or
        another of the same geometry): parked host pages re-register and the
        previously device-resident ones ride swap-in cohorts home. No prompt
        token is recomputed."""
        if self.slots[slot] is not None:
            raise ValueError(f"resume_into: slot {slot} is occupied")
        restored = self.cache.restore_slot(slot, pre.parked)
        if self.cfg.family == "hybrid" and pre.ssm_conv is not None:
            # Into the engine's current side-state tensors (each decode step
            # replaces them).
            conv, sst = self.ssm_state
            conv[:, slot] = pre.ssm_conv.to(self.device, conv.dtype)
            sst[:, slot] = pre.ssm_state.to(self.device, sst.dtype)
        self.slots[slot] = pre.request
        self.slot_len[slot] = pre.parked.total_len
        self.stats.resumes += 1
        self.stats.resumed_pages += restored
        return pre.request

    # ------------------------------------------------------------ internals
    def _fill_slots(self):
        for i in range(self.bs):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.start_request(i, req)

    @tracing.traced("engine.prefill")
    def _prefill(self, slot: int, req: Request):
        """Dense prefill, then page the prompt KV into the warm tier
        (batched: one quant launch for all layers x pages). The KV stays on
        the device in the cache's own type (the reference round-trips it
        through host numpy in f32; the quantization upcasts exactly, so the
        codes and scales are the same)."""
        s = len(req.prompt)
        if req.out_tokens:
            self.stats.re_prefill_tokens += s
        dev = self.device
        batch = {"tokens": torch.as_tensor(req.prompt[None], dtype=torch.int64, device=dev)}
        state = self.model.init_cache(1, max(s + 1, self.pt))
        logits, state = self.model.prefill(self.params, batch, state)
        # Page out everything except the tail that fits the recent window.
        n_full_pages = max((s - self.recent_window // 2) // self.pt, 0)
        k = state.k_cache[:, 0]  # [L,S,KV,hd]
        v = state.v_cache[:, 0]
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
        st.recent_k[:, slot, :tlen] = k[:, n_full_pages * self.pt:s]
        st.recent_v[:, slot, :tlen] = v[:, n_full_pages * self.pt:s]
        st.recent_len[slot] = tlen
        st.total_len[slot] = s
        self.slot_len[slot] = s
        req.out_tokens.append(int(torch.argmax(logits[0, -1])))
        if self.cfg.family == "hybrid":
            # The slot's SSM side state: the recurrent prefill's final states.
            conv, sst = self.ssm_state
            conv[:, slot] = state.conv_state[:, 0].to(conv.dtype)
            sst[:, slot] = state.ssm_state[:, 0]

    def _decode_step(self):
        tr = self.tracer
        with tr.span("engine.decode"):
            tokens = np.zeros((self.bs, 1), np.int64)
            for i, req in enumerate(self.slots):
                if req is not None and req.out_tokens:
                    tokens[i, 0] = req.out_tokens[-1]
            logits, tkv, self.ssm_state, telemetry = self._step_fn(
                self.params, torch.as_tensor(tokens, device=self.device), self.cache.state,
                self.ssm_state,
            )
            self.cache.state = tkv
            # The host waits here for the step's device work.
            with tr.span("engine.decode.wait"):
                telemetry = {k: v.cpu().numpy() for k, v in telemetry.items()}
                next_tok = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()

        self.cache.record_telemetry(telemetry)
        # Advance in-flight migration cohorts by one phase (decode retired a
        # step while migration ran); on an idle media path, spend the step on
        # speculative prefetch (a no-op unless prefetch is on).
        if self.cache.pipeline.busy:
            self.cache.pipeline.tick()
            self.stats.overlapped_steps += 1
        else:
            self.cache.prefetch_tick()

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

    @tracing.traced("engine.page_out")
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
        k, v = st.recent_k, st.recent_v  # [L,B,R,KV,hd], handed to page-out as they are
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

    @tracing.traced("engine.release")
    def _release_slot(self, slot: int):
        """Request finished: free its pages everywhere (batched)."""
        self.cache.release_slot_pages(slot)
        self.slots[slot] = None
        self.slot_len[slot] = 0
        st = self.cache.state
        st.recent_len[slot] = 0
        st.total_len[slot] = 0

    def _end_window(self):
        with self.tracer.span("engine.window"):
            plan, moved = self.cache.end_window()
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
