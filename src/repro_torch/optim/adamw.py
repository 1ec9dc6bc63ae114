"""AdamW over trees of tensors, after ``repro.optim.adamw``.

The update math and the moments are f32; parameters keep their dtype. The
step count is an int32 0-d tensor and the bias corrections ``b**t`` take an
f32 ``t``, as in the reference.

``update`` consumes its ``params`` and ``state``, as the reference's train
step donates both: it writes each leaf in place, one leaf at a time, and
returns the same trees. So a leaf's f32 temporaries are freed before the
next leaf's are made, and a full-width model fits beside its moments on
one card. Use only what it returns afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import pytree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    # schedule(step) -> multiplier on lr; default constant.
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = None
    for x in pytree.leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9))."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: PyTree, max_norm: float):
    """Returns (the tree scaled by ``clip_scale`` in f32 and rounded to each
    leaf's dtype, the norm before clipping)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return pytree.tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


def clipped_f32(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One leaf of ``clip_by_global_norm``'s tree, in f32 (a new tensor),
    without holding the whole clipped tree."""
    gf = g.to(torch.float32) * scale
    return gf if g.dtype == torch.float32 else gf.to(g.dtype).to(torch.float32)


def init(params: PyTree, moment_dtype=torch.float32) -> Dict[str, PyTree]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    device = pytree.leaves(params)[0].device
    return {"m": pytree.tree_map(zeros, params), "v": pytree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def step_terms(step: torch.Tensor, cfg: AdamWConfig):
    """(lr, 1 - b1**t, 1 - b2**t) at the incremented ``step``, with an f32
    ``t``."""
    t = step.to(torch.float32)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None else 1.0)
    return lr, 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t


def adam_leaf(p: torch.Tensor, gf: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              cfg: AdamWConfig, lr, bc1, bc2) -> None:
    """One leaf's step, in place: ``m``/``v`` f32 moments, ``gf`` the f32
    clipped gradient, ``p`` the parameter in its own dtype. The reference's
    operations and roundings: ``m = b1 m + (1 - b1) g``, ``v = max(b2 v +
    (1 - b2) g g, 0)`` (a no-op for f32 moments, which only tiered Adam's
    codes can push below 0), ``p = p - lr ((m / bc1) / (sqrt(v / bc2) +
    eps) + wd p)`` in f32, rounded to p's dtype."""
    m.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
    sq = gf * (1 - cfg.b2)
    v.mul_(cfg.b2).add_(sq.mul_(gf))
    del sq
    v.clamp_(min=0.0)
    den = v.div(bc2).sqrt_().add_(cfg.eps)
    delta = m.div(bc1).div_(den)
    del den
    p32 = p.to(torch.float32)
    delta.add_(p32 * cfg.weight_decay).mul_(lr)
    if p32 is p:
        p.sub_(delta)
    else:
        p.copy_(p32.sub_(delta))


def update(grads: PyTree, state: Dict[str, PyTree], params: PyTree, cfg: AdamWConfig):
    """Returns (params, state, metrics {grad_norm, lr}), ``params`` and
    ``state`` updated in place (see the module docstring)."""
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.grad_clip_norm)
    step = state["step"] + 1
    lr, bc1, bc2 = step_terms(step, cfg)
    with torch.no_grad():
        for p, g, m, v in zip(pytree.leaves(params), pytree.leaves(grads),
                              pytree.leaves(state["m"]), pytree.leaves(state["v"])):
            mf, vf = m.to(torch.float32), v.to(torch.float32)
            adam_leaf(p, clipped_f32(g, scale), mf, vf, cfg, lr, bc1, bc2)
            if mf is not m:  # moments kept in another dtype
                m.copy_(mf)
                v.copy_(vf)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(warmup: int, total: int, min_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(torch.pi * prog))
        return warm * cos

    return fn
