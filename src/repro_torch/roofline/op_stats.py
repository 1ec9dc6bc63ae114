"""Counted FLOPs and bytes of one eager call, the port's counterpart of
``repro.roofline.hlo_stats``.

The reference parses post-SPMD HLO text and multiplies each ``while`` body
by its trip count, because XLA's ``cost_analysis`` counts a loop body once.
Eager PyTorch dispatches every operation of every loop trip, so the port
counts at dispatch instead (a ``TorchDispatchMode``), on real or ``meta``
tensors, and needs no trip counts:

  * matmul FLOPs: 2 * prod(result dims) * K for every ``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``addbmm``, ``mv`` and ``dot`` (``einsum`` and
    ``matmul`` reach these), as ``hlo_stats`` counts dots;
  * traffic bytes: every non-view operation reads its tensor inputs once and
    writes its outputs once (an eager operation runs unfused, so this is
    what it moves). A broadcast (stride-0) dimension is read once.

The backward of a ``torch.autograd`` call is counted too.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
# op -> index of the left operand (its last dim is the contraction K).
_MATMUL_LHS = {
    _aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0, _aten.dot.default: 0,
    _aten.addmm.default: 1, _aten.baddbmm.default: 1, _aten.addbmm.default: 1,
}


@dataclasses.dataclass
class OpStats:
    flops: float  # matmul FLOPs
    traffic_bytes: float  # bytes read and written by the dispatched operations
    n_ops: int  # dispatched non-view operations
    n_matmuls: int


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements (stride-0 dims counted once)."""
    n = math.prod(d for d, s in zip(t.shape, t.stride()) if s != 0) if t.dim() else 1
    return n * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.n_matmuls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _is_view(func):
            return out
        self.n_ops += 1
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(tensor_bytes(t) for t in ins + outs)
        if func in _MATMUL_LHS:
            lhs = args[_MATMUL_LHS[func]]
            k = lhs.shape[-1] if lhs.dim() else 1
            res = outs[0]
            self.flops += 2.0 * res.numel() * k
            self.n_matmuls += 1
        return out


def analyze(fn, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatched."""
    counter = _Counter()
    with counter:
        fn(*args, **kwargs)
    return OpStats(flops=counter.flops, traffic_bytes=counter.bytes, n_ops=counter.n_ops,
                   n_matmuls=counter.n_matmuls)
