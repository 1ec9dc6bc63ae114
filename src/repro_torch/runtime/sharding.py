"""Parameter/activation sharding rules for the (pod, data, model) mesh, after
``repro.runtime.sharding``: the same specs from the same axis sizes.

Tensor-parallel layout (Megatron-style) over the ``model`` axis:
  * attention: q heads column-sharded, output row-sharded; KV projections
    shard over kv-heads when divisible, otherwise over the d_model dim,
  * MLP: gate/up column-, down row-sharded,
  * MoE: experts sharded over ``model`` (expert parallelism); router
    replicated,
  * embeddings / lm_head: vocab-sharded,
  * SSM blocks, norms, biases and scales: replicated.

``pod`` and ``data`` are both batch axes. With ``fsdp=True`` the d_model
dimension of the large block weights and both moment trees additionally
shard over ``data`` (ZeRO-3 style).

The specs are computed from the mesh's axis sizes alone, so they hold on an
abstract mesh of any shape. The port runs on one device: ``shardings_for``
pairs each spec with its mesh (there is no placement to make), and
``activation_sharding``'s constraint is the identity. Trees are the port's
parameter layout: nested dicts whose leaves have a ``.shape`` (tensors,
``meta`` tensors included); paths are the reference's ("blocks/attn/wq").
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.mesh import PartitionSpec as P

PyTree = Any


def _map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (a ``PartitionSpec`` is a
    leaf, as is anything that is not a dict), with the matching leaves of
    ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _map_with_path(fn: Callable, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_axes_for(mesh: Mesh, batch_size: int) -> Tuple[str, ...]:
    """Largest prefix of the batch axes whose product divides batch_size
    (long_500k has global_batch=1: it shards over no batch axis)."""
    out = []
    prod = 1
    for a in batch_axes(mesh):
        sz = axis_size(mesh, a)
        if batch_size % (prod * sz) == 0:
            out.append(a)
            prod *= sz
        else:
            break
    return tuple(out)


def bax_spec(mesh: Mesh, batch_size: int):
    axes = batch_axes_for(mesh, batch_size)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def param_spec(
    path: str,
    shape: Tuple[int, ...],
    cfg: ModelConfig,
    mesh: Mesh,
    parallel: ParallelConfig,
) -> P:
    """PartitionSpec for one parameter leaf (leading L dim when stacked)."""
    tp = axis_size(mesh, "model")
    dp = axis_size(mesh, "data")
    fsdp = parallel.fsdp

    stacked = path.startswith("blocks/")
    lead: Tuple[Optional[str], ...] = (None,) if stacked else ()

    def spec(*rest):
        return P(*(lead + rest))

    def div(dim: int, ax: int) -> bool:
        return shape[ax + len(lead)] % dim == 0 if dim > 1 else True

    def replicated():
        return spec(*((None,) * (len(shape) - len(lead))))

    d_shard = "data" if (fsdp and div(dp, 0)) else None  # d_model dim helper

    # ---- embeddings / head -------------------------------------------------
    if re.search(r"(^|/)embed$", path):
        return P("model" if shape[0] % tp == 0 else None,
                 "data" if fsdp and shape[1] % dp == 0 else None)
    if re.search(r"(^|/)lm_head$", path):
        return P("data" if fsdp and shape[0] % dp == 0 else None,
                 "model" if shape[1] % tp == 0 else None)

    # ---- attention: heads when they divide, else the d_model dim -----------
    if re.search(r"attn/w[qkv]$", path):
        if div(tp, 1):
            return spec(d_shard, "model", None)
        return spec("model" if div(tp, 0) else d_shard, None, None)
    if re.search(r"attn/wo$", path):
        if div(tp, 0):
            return spec("model", None, d_shard)
        return spec(None, None, "model" if div(tp, 2) else d_shard)
    if re.search(r"attn/b[qkv]$", path) or re.search(r"attn/bo$", path):
        return replicated()

    # ---- MoE: experts over model, the FFN dim over data --------------------
    if re.search(r"moe/router$", path):
        return spec(None, None)
    if re.search(r"moe/w_(gate|up)$", path):
        f_ax = "data" if (fsdp and div(dp, 2)) else None
        return spec("model" if div(tp, 0) else None, None, f_ax)
    if re.search(r"moe/w_down$", path):
        f_ax = "data" if (fsdp and div(dp, 1)) else None
        return spec("model" if div(tp, 0) else None, f_ax, None)

    # ---- dense MLP ---------------------------------------------------------
    if re.search(r"ffn/w_(gate|up)$", path):
        return spec(d_shard, "model" if div(tp, 1) else None)
    if re.search(r"ffn/w_down$", path):
        return spec("model" if div(tp, 0) else None, d_shard)

    # ---- SSM mixers, FFN biases, norms and scalars: replicated -------------
    return replicated()


def param_specs(params_shape: PyTree, cfg: ModelConfig, mesh: Mesh,
                parallel: ParallelConfig) -> PyTree:
    """Tree of PartitionSpec matching a params tree (tensors or ``meta``
    tensors)."""
    return _map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), cfg, mesh, parallel),
        params_shape)


def shardings_for(params_shape: PyTree, cfg: ModelConfig, mesh: Mesh,
                  parallel: ParallelConfig) -> PyTree:
    """Each leaf's (mesh, spec). One device holds every leaf whole, so there
    is no placement to make."""
    return _map(lambda s: (mesh, s), param_specs(params_shape, cfg, mesh, parallel))


def opt_state_specs(param_specs_tree: PyTree) -> dict:
    """AdamW moments inherit their parameter's spec; step is replicated."""
    return {"m": param_specs_tree, "v": param_specs_tree, "step": P()}


def _used_axes(spec) -> set:
    used = set()
    for s in spec:
        if s is not None:
            used.update(s if isinstance(s, tuple) else (s,))
    return used


def zero1_moment_specs(param_specs_tree: PyTree, params_shape: PyTree, mesh: Mesh) -> PyTree:
    """ZeRO-1: shard optimizer moments over the ``data`` axis even where the
    parameter itself is replicated, at the first free, divisible dimension
    of each leaf's spec."""
    dp = axis_size(mesh, "data")
    if dp <= 1:
        return param_specs_tree

    def one(spec, leaf):
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        if "data" in _used_axes(spec):
            return spec
        for i, (s, dim) in enumerate(zip(parts, leaf.shape)):
            if s is None and dim % dp == 0 and dim > 0:
                parts[i] = "data"
                return P(*parts)
        return spec

    return _map(one, param_specs_tree, params_shape)


def _fits(spec, shape, mesh: Mesh) -> bool:
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for s, d in zip(parts, shape):
        if s is None:
            continue
        size = 1
        for n in (s if isinstance(s, tuple) else (s,)):
            size *= axis_size(mesh, n)
        if d % size:
            return False
    return True


def tiered_opt_specs(param_specs_tree: PyTree, opt_state, mesh: Mesh):
    """Specs of a ``tiered_adam`` state (the reference builds them in
    ``runtime/train.make_train_step``): a payload keeps its parameter's spec
    where it still divides, else drops the last-dim sharding, else is
    replicated; scales drop the last-dim sharding. Returns a
    ``TieredAdamState`` of specs."""
    def moment_spec(spec, mom_leaf):
        if _fits(spec, mom_leaf.shape, mesh):
            return spec
        parts = list(spec)
        if parts:
            parts[-1] = None
        cand = P(*parts)
        return cand if _fits(cand, mom_leaf.shape, mesh) else P()

    def scale_spec(spec, sc_leaf):
        if sc_leaf.shape[0] == 0:
            return P()
        parts = list(spec) + [None] * (len(sc_leaf.shape) - len(spec))
        parts[-1] = None
        cand = P(*parts)
        return cand if _fits(cand, sc_leaf.shape, mesh) else P()

    return dataclasses.replace(
        opt_state,
        m=_map(moment_spec, param_specs_tree, opt_state.m),
        m_scales=_map(scale_spec, param_specs_tree, opt_state.m_scales),
        v=_map(moment_spec, param_specs_tree, opt_state.v),
        v_scales=_map(scale_spec, param_specs_tree, opt_state.v_scales),
        step=P(),
    )


def batch_spec(mesh: Mesh, batch: PyTree) -> PyTree:
    """Inputs shard over the batch axes (divisibility-checked per leaf);
    positions [3,B,S] shard dim 1."""
    def one(path, leaf):
        nd = len(leaf.shape)
        if path == "positions" and nd == 3 and leaf.shape[0] == 3:
            return P(None, bax_spec(mesh, leaf.shape[1]), *([None] * (nd - 2)))
        return P(bax_spec(mesh, leaf.shape[0]), *([None] * (nd - 1)))

    return _map_with_path(one, batch)


@dataclasses.dataclass(frozen=True)
class ActivationSharding:
    """The reference's activation layout record (batch, heads and kv-seq
    axes, TP degree) and its ``constrain(x, spec)``. The port's models take
    no sharding argument; on one device the constraint is the identity."""

    batch: Any = None
    heads: Optional[str] = None
    kv_seq: Optional[str] = None
    constrain: Callable = lambda x, spec: x
    tp: int = 1


def activation_sharding(mesh: Mesh, parallel: ParallelConfig,
                        batch_size: Optional[int] = None) -> ActivationSharding:
    if batch_size is None:
        axes = batch_axes(mesh)
        bax = axes if len(axes) > 1 else (axes[0] if axes else None)
    else:
        bax = bax_spec(mesh, batch_size)
    return ActivationSharding(
        batch=bax,
        heads="model" if axis_size(mesh, "model") > 1 else None,
        kv_seq="model" if parallel.shard_kv_seq else None,
        tp=axis_size(mesh, "model"),
    )


def decode_state_specs(cfg: ModelConfig, mesh: Mesh, parallel: ParallelConfig,
                       batch_size: int, max_len: int):
    """Specs of a ``DecodeState``: KV caches shard over batch (+ model on
    the kv-seq axis when sequence-parallel decode is on)."""
    from repro_torch.models.transformer import DecodeState

    bax = bax_spec(mesh, batch_size)
    tp = axis_size(mesh, "model")
    kv_seq_ax = "model" if (parallel.shard_kv_seq and max_len % tp == 0) else None
    kvh = cfg.n_kv_heads or 1
    kv_head_ax = None
    if kv_seq_ax is None and cfg.has_attention and kvh % tp == 0 and tp > 1:
        kv_head_ax = "model"
    return DecodeState(
        k_cache=P(None, bax, kv_seq_ax, kv_head_ax, None),
        v_cache=P(None, bax, kv_seq_ax, kv_head_ax, None),
        cache_len=P(),
        conv_state=P(None, bax, None, None),
        ssm_state=P(None, bax, None, None, None),
    )


def per_device_bytes(spec, shape, itemsize: int, mesh: Mesh) -> int:
    """Bytes of one device's shard of a [shape] leaf under ``spec``."""
    n = 1
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for s, d in zip(parts, shape):
        size = 1
        if s is not None:
            for a in (s if isinstance(s, tuple) else (s,)):
                size *= axis_size(mesh, a)
        n *= -(-int(d) // size)
    return n * itemsize

