"""Tiered/compressed Adam moments, after ``repro.optim.tiered_adam``:
TierScape applied to optimizer state.

Each leaf's moment storage lives in a software-defined compressed tier,

    policy[leaf_path] in {"none" (f32), "bf16", "int8", "int4"},

keyed by the reference's path strings (``blocks/attn/wq``). int8/int4 are
µ-law codes with per-group absmax scales along the last axis (the group
from ``group_for``); int4 codes are nibble-packed, the even index in the
low nibble, and its second moment is kept at int8. An update decodes a
leaf, applies Adam, and encodes it again.

``update`` consumes ``params`` and ``state`` as ``adamw.update`` does (the
reference's train step donates them) and takes the leaves one at a time,
dropping each leaf's f32 working set before the next: the reference forces
the same order with an ``optimization_barrier`` chain, and on one card it
decides whether a full-width model fits. f32 ("none") moments are updated
in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import pytree
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

PyTree = Any

GROUP = 128
QMAX = {"int8": 127.0, "int4": 7.0}
# The reference's production data-axis degree: its group choice keeps the
# number of groups divisible by it (the port's groups are the same).
DP_HINT = 16


def group_for(last_dim: int) -> int:
    """Group size for a leaf whose trailing dim is ``last_dim``: prefer 128,
    fall back so that last_dim % g == 0 and (last_dim//g) % DP_HINT == 0."""
    for g in (128, 96, 64, 48, 32):
        if last_dim % g == 0 and (last_dim // g) % DP_HINT == 0:
            return g
    for g in (128, 96, 64, 48, 32):
        if last_dim % g == 0:
            return g
    return GROUP


# µ-law companding: logarithmic codes give small moments relative precision
# even in groups dominated by a large value.
MU = {"int8": 255.0, "int4": 15.0}


def _const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``c`` as an f32 0-d tensor on ``x``'s device. CUDA multiplies by the
    reciprocal of a Python scalar (or CPU 0-d) divisor, which rounds apart
    from the CPU's and the reference's division; a device tensor divides."""
    return torch.tensor(c, dtype=torch.float32, device=x.device)


def _mulaw_enc(xn: torch.Tensor, mu: float, qmax: float) -> torch.Tensor:
    log1p_mu = torch.log1p(_const(xn, mu))  # in f32, as the reference
    return torch.sign(xn) * torch.log1p(mu * torch.abs(xn)) / log1p_mu * qmax


def _mulaw_dec(q: torch.Tensor, mu: float, qmax: float) -> torch.Tensor:
    y = q / _const(q, qmax)
    return torch.sign(y) * torch.expm1(torch.abs(y) * torch.log1p(_const(q, mu))) / _const(q, mu)


def _no_scales(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((0, 1), dtype=torch.float32, device=x.device)


def encode_moment(x: torch.Tensor, codec: str):
    """f32 moment leaf -> (payload, scales) under ``codec``. Grouping runs
    along the last axis only (padded to the group), so every leading dim
    survives. Codec-free leaves carry a zero-size scales tensor. ``"none"``
    hands back ``x`` itself when it is f32."""
    if codec == "none":
        return x.to(torch.float32), _no_scales(x)
    if codec == "bf16":
        return x.to(torch.bfloat16), _no_scales(x)
    xf = x.to(torch.float32)
    if xf.dim() == 0:
        xf = xf.reshape(1)
    last = xf.shape[-1]
    grp = group_for(last)
    pad = (-last) % grp
    if pad:
        xf = F.pad(xf, (0, pad))
    lead = xf.shape[:-1]
    ng = xf.shape[-1] // grp
    g = xf.reshape(*lead, ng, grp)
    qmax = QMAX[codec]
    scale = torch.clamp(torch.amax(torch.abs(g), dim=-1), min=1e-20)  # [*lead, ng]
    q = torch.clamp(torch.round(_mulaw_enc(g / scale[..., None], MU[codec], qmax)), -qmax, qmax)
    q = q.reshape(*lead, ng * grp).to(torch.int32)
    if codec == "int4":
        lo = q[..., 0::2] & 0xF
        hi = q[..., 1::2] & 0xF
        return (lo | (hi << 4)).to(torch.uint8), scale
    return q.to(torch.int8), scale


def decode_moment(payload: torch.Tensor, scales: torch.Tensor, codec: str, shape) -> torch.Tensor:
    """(payload, scales) -> the f32 moment of ``shape``. ``"none"`` hands
    back the payload itself (f32)."""
    if codec in ("none", "bf16"):
        return payload.to(torch.float32)
    if codec == "int4":
        p = payload.to(torch.int32)
        lo = p & 0xF
        hi = (p >> 4) & 0xF
        lo = torch.where(lo >= 8, lo - 16, lo)
        hi = torch.where(hi >= 8, hi - 16, hi)
        q = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
        q = q.to(torch.float32)
    else:
        q = payload.to(torch.float32)
    lead = q.shape[:-1]
    last = shape[-1] if len(shape) else 1
    grp = group_for(last)
    ng = q.shape[-1] // grp
    g = q.reshape(*lead, ng, grp)
    x = _mulaw_dec(g, MU[codec], QMAX[codec]) * scales[..., None]
    return x.reshape(*lead, ng * grp)[..., :last].reshape(shape)


@dataclasses.dataclass
class TieredAdamState:
    m: PyTree  # payloads
    m_scales: PyTree
    v: PyTree
    v_scales: PyTree
    step: torch.Tensor
    policy: Tuple[Tuple[str, str], ...]  # sorted (leaf path, codec) pairs

    # Data fields in the reference's registration order (``repro_torch.
    # pytree``); ``policy`` is static metadata.
    PYTREE_FIELDS = ("m", "m_scales", "v", "v_scales", "step")


def _freeze_policy(policy: Dict[str, str]):
    return tuple(sorted(policy.items()))


def _v_codec(codec: str) -> str:
    """4-bit Adam keeps the second moment at 8 bits (1/sqrt(v) blows up
    under a 15-level code)."""
    return "int8" if codec == "int4" else codec


def default_policy(params: PyTree, cold_codec: str = "int8") -> Dict[str, str]:
    """Embedding-like leaves (vocab-scale rows) -> compressed; rest f32."""
    return {p: cold_codec if ("embed" in p or "lm_head" in p) else "none"
            for p, _ in pytree.leaves_with_path(params)}


def init(params: PyTree, policy: Dict[str, str]) -> TieredAdamState:
    enc, enc_v = [], []
    for path, p in pytree.leaves_with_path(params):
        # One zeros tensor each: an f32 payload is the tensor itself, and
        # the update writes it in place.
        enc.append(encode_moment(torch.zeros(p.shape, device=p.device), policy[path]))
        enc_v.append(encode_moment(torch.zeros(p.shape, device=p.device),
                                   _v_codec(policy[path])))
    device = pytree.leaves(params)[0].device
    return TieredAdamState(
        m=pytree.unflatten(params, [e[0] for e in enc]),
        m_scales=pytree.unflatten(params, [e[1] for e in enc]),
        v=pytree.unflatten(params, [e[0] for e in enc_v]),
        v_scales=pytree.unflatten(params, [e[1] for e in enc_v]),
        step=torch.zeros((), dtype=torch.int32, device=device),
        policy=_freeze_policy(policy),
    )


def _moment_leaves(state: TieredAdamState):
    return zip(*(pytree.leaves(getattr(state, f)) for f in ("m", "m_scales", "v", "v_scales")))


def update(grads: PyTree, state: TieredAdamState, params: PyTree, cfg: AdamWConfig
           ) -> Tuple[PyTree, TieredAdamState, Dict[str, Any]]:
    """Returns (params, state, metrics {grad_norm, lr}), both updated in
    place (see the module docstring)."""
    gnorm = adamw.global_norm(grads)
    scale = adamw.clip_scale(gnorm, cfg.grad_clip_norm)
    step = state.step + 1
    lr, bc1, bc2 = adamw.step_terms(step, cfg)
    pol = dict(state.policy)
    out = []
    with torch.no_grad():
        for (path, p), g, (m_pay, m_sc, v_pay, v_sc) in zip(
                pytree.leaves_with_path(params), pytree.leaves(grads), _moment_leaves(state)):
            codec = pol[path]
            m = decode_moment(m_pay, m_sc, codec, p.shape)
            v = decode_moment(v_pay, v_sc, _v_codec(codec), p.shape)
            adamw.adam_leaf(p, adamw.clipped_f32(g, scale), m, v, cfg, lr, bc1, bc2)
            out.append(encode_moment(m, codec) + encode_moment(v, _v_codec(codec)))
            del m, v
    for i, f in enumerate(("m", "m_scales", "v", "v_scales")):
        setattr(state, f, pytree.unflatten(params, [o[i] for o in out]))
    state.step = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def moment_bytes(state: TieredAdamState) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for f in ("m", "m_scales", "v", "v_scales")
               for leaf in pytree.leaves(getattr(state, f)))


def repack(state: TieredAdamState, params: PyTree, new_policy: Dict[str, str]
           ) -> TieredAdamState:
    """Tier migration for optimizer state: decode under the old policy,
    re-encode under the new one (the manager calls this between windows).
    f32 leaves that stay f32 are shared with ``state``."""
    pol = dict(state.policy)
    out = []
    for (path, p), (m_pay, m_sc, v_pay, v_sc) in zip(pytree.leaves_with_path(params),
                                                      _moment_leaves(state)):
        m = decode_moment(m_pay, m_sc, pol[path], p.shape)
        v = decode_moment(v_pay, v_sc, _v_codec(pol[path]), p.shape)
        out.append(encode_moment(m, new_policy[path])
                   + encode_moment(v, _v_codec(new_policy[path])))
    trees = [pytree.unflatten(params, [o[i] for o in out]) for i in range(4)]
    return TieredAdamState(*trees, step=state.step, policy=_freeze_policy(new_policy))
