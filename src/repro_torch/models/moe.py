"""Mixture-of-Experts FFN, after ``repro.models.moe``: grouped,
capacity-dropping dispatch, per-expert SwiGLU, gated combine.

Each batch row is a dispatch GROUP. Per group: f32 top-k routing, a stable
sort of the assignments by expert, and a capacity-C gather building
``xe [B, E, C, D]``; the expert products run as one batched matmul over the
experts (every expert's weights are read, as the reference's einsum reads
them); the combine adds each token's gated expert outputs back in ascending
expert order. Aux: Switch-style load balance, router z-loss and the
fraction of assignments dropped by capacity.

The reference shards groups over data and experts over model, with sharding
constraints around the expert all-to-all; on one device those constraints
are the identity and the module takes none. What stays is the int8 wire
round trip (``A2A_WIRE_INT8``), which changes the values the experts see.

Parity notes. Routing is discrete, so it is computed where it cannot drift:
the router product in f32 with TF32 off on the card, and top-k as a stable
descending sort, so equal probabilities go to the lower expert index as
``jax.lax.top_k`` sends them. The combine is a gather per token, never an
atomic scatter-add, so its bf16 sums are the same on every run and device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

# Sequences longer than this are dispatched in chunks, so the live expert
# buffers stay O(chunk); aux is the mean over chunks.
MOE_SEQ_CHUNK = 4096

# Quantize the dispatch/combine payloads to int8 around the expert
# all-to-all (per-slot absmax scales), as the reference does.
A2A_WIRE_INT8 = True


def set_a2a_wire_int8(flag: bool) -> None:
    global A2A_WIRE_INT8
    A2A_WIRE_INT8 = flag


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, lead=(), dtype=torch.bfloat16,
                    device="cpu") -> dict:
    """Router f32 [D, E]; w_gate/w_up [E, D, F] and w_down [E, F, D] in
    ``dtype``, each with leading dims ``lead`` (the layer stack). Expert
    weights are drawn one leading index at a time, so the f32 draw never
    holds a whole stack."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    lead = tuple(lead)

    def experts(shape):
        out = torch.empty(lead + shape, dtype=dtype, device=device)
        flat = out.view((-1,) + shape)
        for i in range(flat.shape[0]):
            flat[i] = layers.dense_init(gen, shape, in_axis=1, dtype=dtype, device=device)
        return out

    return {
        "router": layers.dense_init(gen, lead + (d, e), in_axis=len(lead), dtype=torch.float32,
                                    device=device),
        "w_gate": experts((e, d, f)),
        "w_up": experts((e, d, f)),
        "w_down": experts((e, f, d)),
    }


def _wire_quant(x: torch.Tensor):
    """[..., D] -> (int8 payload, f32 scale per slot): absmax / 127 (at
    least 1e-20), an IEEE divide, round half to even, clip to +-127."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # A divisor on the tensor's device: CUDA multiplies by the reciprocal of
    # a Python scalar divisor, which rounds apart from the CPU's (and the
    # reference's) division.
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-20)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _wire_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


class _WireTransfer(torch.autograd.Function):
    """Forward: the int8 round trip of ``x``. Backward: the same round trip
    of the cotangent (the reference's custom VJP sends it down the mirrored
    int8 path). Without it, ``round`` has a zero gradient and nothing
    reaches the experts' inputs: training breaks without an error."""

    @staticmethod
    def forward(ctx, x):
        return _wire_dequant(*_wire_quant(x), x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _wire_dequant(*_wire_quant(g), g.dtype)


def make_wire_transfer():
    """The int8-compressed transfer around the expert all-to-all: on one
    device, quantize then dequantize (the reference pins the payload to the
    source and target shardings in between), with the reference's backward
    (``_WireTransfer``)."""
    return _WireTransfer.apply


@contextlib.contextmanager
def _no_tf32(on_cuda: bool):
    """f32 products at full precision on the card: routing is discrete, and
    a TF32 router would move experts in and out of the top k."""
    if not on_cuda:
        yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, capacity: Optional[int] = None
            ) -> Tuple[torch.Tensor, dict]:
    """x: [B, S, D] -> (y [B, S, D], aux dict of 0-dim f32 tensors)."""
    b, s, _ = x.shape
    if s > MOE_SEQ_CHUNK and s % MOE_SEQ_CHUNK == 0:
        ys, auxs = zip(*(moe_ffn(p, cfg, xi, capacity)
                         for xi in torch.split(x, MOE_SEQ_CHUNK, dim=1)))
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return torch.cat(ys, dim=1), aux
    return _moe_ffn_inner(p, cfg, x, capacity)


def route(p: dict, cfg: ModelConfig, x: torch.Tensor, capacity: Optional[int] = None) -> dict:
    """The dispatch plan of one call, per group (batch row): f32 router
    logits and probabilities, the top-k ``expert_ids`` and renormalized
    ``gate_vals`` [B, S, k], the ``capacity`` C, and per expert slot [B, E, C]
    whether it holds an assignment (``slot_valid``), its source token
    (``tok_idx``) and gate (``slot_gate``); also the stable ``order`` of the
    assignments by expert and each expert's ``seg_start`` in it."""
    m = cfg.moe
    b, s, _ = x.shape
    e, k = m.n_experts, m.experts_per_token
    if capacity is None:
        capacity = max(int(s * k * m.capacity_factor / e), 1)
        capacity = -(-capacity // 4) * 4
    dev = x.device

    with _no_tf32(x.is_cuda):
        logits = torch.matmul(x.to(torch.float32), p["router"])  # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[..., :k], expert_ids[..., :k]  # [B, S, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Per-group sort-by-expert dispatch.
    a = s * k  # assignments per group
    ids_flat = expert_ids.reshape(b, a)
    order = torch.sort(ids_flat, dim=1, stable=True).indices  # [B, A]
    counts = F.one_hot(ids_flat, e).sum(dim=1)  # [B, E]
    seg_start = torch.cumsum(counts, dim=1) - counts  # [B, E]
    c_rng = torch.arange(capacity, device=dev)
    slot_valid = c_rng[None, None, :] < torch.clamp(counts, max=capacity)[..., None]  # [B,E,C]
    gidx = torch.clamp(seg_start[..., None] + c_rng[None, None, :], 0, a - 1)  # [B,E,C]
    assign_idx = torch.gather(order, 1, gidx.reshape(b, e * capacity))
    return {
        "logits": logits, "probs": probs, "gate_vals": gate_vals, "expert_ids": expert_ids,
        "capacity": capacity, "order": order, "seg_start": seg_start, "slot_valid": slot_valid,
        "tok_idx": (assign_idx // k).reshape(b, e, capacity),
        "slot_gate": torch.gather(gate_vals.reshape(b, a), 1, assign_idx).reshape(b, e, capacity),
    }


def _moe_ffn_inner(p: dict, cfg: ModelConfig, x: torch.Tensor, capacity: Optional[int] = None
                   ) -> Tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.experts_per_token
    dev = x.device
    plan = route(p, cfg, x, capacity)
    capacity, slot_valid = plan["capacity"], plan["slot_valid"]
    expert_ids, logits, probs = plan["expert_ids"], plan["logits"], plan["probs"]

    # Aux losses (global over the batch).
    me = probs.mean(dim=(0, 1))  # [E]
    ce = F.one_hot(expert_ids, e).to(torch.float32).mean(dim=(0, 1, 2))
    load_balance = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # Gather tokens into expert slots.
    xe = torch.gather(x, 1, plan["tok_idx"].reshape(b, e * capacity, 1).expand(-1, -1, d))
    xe = torch.where(slot_valid[..., None], xe.reshape(b, e, capacity, d), 0)
    if A2A_WIRE_INT8:
        xe = make_wire_transfer()(xe)

    # --- per-expert SwiGLU: one batched product over the experts ----------
    xs = xe.permute(1, 0, 2, 3).reshape(e, b * capacity, d)
    gate = torch.bmm(xs, p["w_gate"])
    up = torch.bmm(xs, p["w_up"])
    ye = torch.bmm(layers.swiglu(gate, up), p["w_down"])
    ye = ye.reshape(e, b, capacity, d).permute(1, 0, 2, 3)  # [B, E, C, D]
    if A2A_WIRE_INT8:
        ye = make_wire_transfer()(ye)

    # --- combine: each token's gated outputs added in ascending expert order
    # (the order of the reference's scatter-add over (expert, slot)), one
    # rounding per add, as a gather per token: no atomics.
    contrib = ye * (plan["slot_gate"] * slot_valid)[..., None].to(ye.dtype)
    a = s * k
    ids_flat, order = expert_ids.reshape(b, a), plan["order"]
    pos = torch.empty_like(order).scatter_(1, order, torch.arange(a, device=dev).expand(b, a))
    slot = pos - torch.gather(plan["seg_start"], 1, ids_flat)  # each assignment's expert slot
    kept = slot < capacity
    src = torch.where(kept, ids_flat * capacity + slot, 0)  # row of contrib, [B, A]
    by_expert = torch.sort(expert_ids, dim=-1).indices  # [B, S, k]; experts are distinct
    j = (torch.arange(s, device=dev)[None, :, None] * k + by_expert).reshape(b, a)
    rows = torch.gather(src, 1, j)
    keep = torch.gather(kept, 1, j).reshape(b, s, k, 1)
    parts = torch.gather(contrib.reshape(b, e * capacity, d), 1,
                         rows[..., None].expand(-1, -1, d)).reshape(b, s, k, d)
    parts = torch.where(keep, parts, 0)
    yt = torch.zeros((b, s, d), dtype=x.dtype, device=dev)
    for r in range(k):
        yt = yt + parts[:, :, r]

    aux = {
        "load_balance": load_balance,
        "router_z": z_loss,
        "dropped_frac": 1.0 - (slot_valid.sum() / (b * a)).to(torch.float32),
    }
    return yt, aux
