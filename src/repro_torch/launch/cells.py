"""Cell construction, after ``repro.launch.cells``: one (architecture x
input-shape) combination -> the step function, its abstract arguments on the
``meta`` device and their specs, which the dry-run counts.

Cell kinds:
  train_4k    -> train_step   (loss+grad+AdamW; fsdp per size heuristic,
                               microbatch grad accumulation)
  prefill_32k -> prefill_step (full forward)
  decode_32k  -> serve_step   (one token vs a seq_len dense KV cache)
  long_500k   -> serve_step   (SSM: recurrent state; hybrid: TIERED
                               compressed KV pools through the port's
                               ``make_tiered_decode_step``, plain branch)

The step functions are the port's own; they run on ``meta`` tensors, so a
cell of any size is built and counted without memory or a device. The
reference's ``Cell.lower`` (``jax.jit(...).lower``) has no eager
counterpart: ``fn(*abstract_args)`` is the cell's program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

import repro_torch.configs as configs
from repro_torch import pytree
from repro_torch.configs.base import SHAPES, ModelConfig, ParallelConfig, TierScapeRunConfig
from repro_torch.device import abstract
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models import inputs as minputs
from repro_torch.models.transformer import Model, _attn_layer_count, ssm_state_shapes
from repro_torch.optim import adamw, tiered_adam
from repro_torch.runtime import serve as serve_rt
from repro_torch.runtime import sharding as shr
from repro_torch.runtime import train as train_rt

PyTree = Any


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    in_specs: Tuple
    abstract_args: Tuple
    mesh: Mesh
    notes: str = ""
    donate: Tuple[int, ...] = ()
    out_specs: Any = None

    def run(self):
        """The cell's program on its abstract arguments."""
        return self.fn(*self.abstract_args)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch(cfg: ModelConfig, batch: int, seq: int) -> dict:
    return {k: _meta(shape, dt) for k, (shape, dt) in
            minputs.train_batch_spec(cfg, batch, seq).items()}


def _dp(mesh: Mesh) -> int:
    return shr.axis_size(mesh, "data") * shr.axis_size(mesh, "pod")


def default_parallel(cfg: ModelConfig, shape_name: str, mesh: Mesh) -> ParallelConfig:
    kind = SHAPES[shape_name].kind
    params_gb = cfg.param_count() * 2 / 1024**3
    tp = shr.axis_size(mesh, "model")
    if kind == "train":
        # Training: params + f32 moments resident -> FSDP early.
        fsdp = params_gb / max(tp, 1) > 2.0
    else:
        # Inference: only bf16 params resident; FSDP would re-gather params
        # every decode token — avoid unless TP alone can't fit them.
        fsdp = params_gb / max(tp, 1) > 8.0
    accum = 1
    if kind == "train":
        sh = SHAPES[shape_name]
        local_batch = max(sh.global_batch // _dp(mesh), 1)
        # Per-microbatch activation budget, per family.
        target_mb = {"ssm": 16, "hybrid": 16, "moe": 64, "vlm": 64}.get(cfg.family, 128)
        per_seq_bytes = sh.seq_len * max(cfg.d_model, 1) * 2
        micro = max(int((target_mb << 20) // per_seq_bytes), 1)
        while local_batch % micro and micro > 1:
            micro -= 1
        accum = max(local_batch // micro, 1)
    return ParallelConfig(
        fsdp=fsdp,
        grad_accum=accum,
        shard_kv_seq=(kind == "decode" and cfg.has_attention),
    )


def moe_tiered_policy(params_shape) -> dict:
    """MoE train cells store moments through compressed tiers (embeddings &
    expert weights int8)."""
    return {p: "int8" if ("embed" in p or "lm_head" in p or "/moe/w_" in p) else "none"
            for p, _ in pytree.leaves_with_path(params_shape)}


def build_cell(
    arch: str,
    shape_name: str,
    mesh: Mesh,
    parallel: Optional[ParallelConfig] = None,
    smoke: bool = False,
    tiered_kv: Optional[bool] = None,
    page_tokens: int = 64,
    warm_frac: float = 0.125,
    depth: Optional[int] = None,
    batch_size: Optional[int] = None,
) -> Cell:
    """The cell of ``arch`` x ``shape_name`` on ``mesh``. ``depth`` cuts the
    config to that many layers and ``batch_size`` replaces the shape's
    global batch (the dry-run counts cut cells and extrapolates); the
    parallel config defaults from the uncut cell."""
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    parallel = parallel or default_parallel(cfg, shape_name, mesh)
    shape = SHAPES[shape_name]
    if batch_size is not None:
        shape = dataclasses.replace(shape, global_batch=batch_size)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    # The step builders take a CPU model (no storage is made); every
    # argument is a meta tensor.
    model = Model(cfg, parallel, device="cpu")
    notes = f"fsdp={parallel.fsdp} accum={parallel.grad_accum} kvseq={parallel.shard_kv_seq}"
    params_shape = serve_rt.abstract_params(model)
    p_specs = shr.param_specs(params_shape, cfg, mesh, parallel)

    if shape.kind == "train":
        batch = _batch(cfg, shape.global_batch, shape.seq_len)
        tiered_policy = moe_tiered_policy(params_shape) if cfg.family == "moe" else None
        step = train_rt.make_train_step(model, adamw.AdamWConfig(), parallel, batch,
                                        tiered_policy)
        if tiered_policy is not None:
            opt = tiered_adam.init(params_shape, tiered_policy)
            o_specs = shr.tiered_opt_specs(p_specs, opt, mesh)
        else:
            opt = adamw.init(params_shape)
            m_specs = shr.zero1_moment_specs(p_specs, params_shape, mesh)
            o_specs = {"m": m_specs, "v": m_specs, "step": P()}
        in_specs = (p_specs, o_specs, shr.batch_spec(mesh, batch))
        return Cell(arch, shape_name, "train", step.fn, in_specs, (params_shape, opt, batch),
                    mesh, notes, donate=(0, 1), out_specs=(p_specs, o_specs, None))

    if shape.kind == "prefill":
        batch = _batch(cfg, shape.global_batch, shape.seq_len)
        batch.pop("targets", None)
        batch.pop("loss_mask", None)
        fn, _ = serve_rt.make_prefill_step(model, mesh, parallel)
        in_specs = (p_specs, shr.batch_spec(mesh, batch))
        return Cell(arch, shape_name, "prefill", fn, in_specs, (params_shape, batch), mesh, notes)

    # ---- decode kinds -------------------------------------------------------
    if not cfg.is_decoder:
        raise ValueError(f"{arch} has no decode step")
    use_tiered = tiered_kv if tiered_kv is not None else (
        shape_name == "long_500k" and cfg.has_attention
    )
    bsz = shape.global_batch
    bax = shr.bax_spec(mesh, bsz)
    tok = _meta((bsz, 1), torch.int32)

    if use_tiered:
        ts_cfg = TierScapeRunConfig(enabled=True)
        n_pages = shape.seq_len // page_tokens
        warm_pages = max(int(n_pages * warm_frac) * max(bsz, 1), 8)
        cold_pages = max(n_pages * max(bsz, 1), 8)
        with abstract():
            tkv = serve_rt.init_tiered_kv_state(
                cfg, bsz, page_tokens=page_tokens, warm_pages=warm_pages,
                cold_pages=cold_pages, max_pages_per_seq=n_pages, recent_window=256,
                n_attn_layers=_attn_layer_count(cfg), device="cpu")
        if cfg.family == "hybrid":
            conv_shape, ssm_shape = ssm_state_shapes(cfg, bsz)
            ssm_sds = (_meta(conv_shape, torch.bfloat16), _meta(ssm_shape, torch.float32))
            ssm_specs = (P(None, bax, None, None), P(None, bax, None, None, None))
        else:
            ssm_sds = (_meta((0,), torch.float32), _meta((0,), torch.float32))
            ssm_specs = (P(), P())
        step = serve_rt.make_tiered_decode_step(model, ts_cfg, device="cpu")

        def fn(*args):
            # On the per-pool route, which reads each pool's pages once as
            # the card does: the fused route's plain version picks each codec
            # class's columns by value (``nonzero``), which ``meta`` lacks.
            fused = kops.fused_route()
            kops.use_fused(False)
            try:
                return step(*args)
            finally:
                kops.use_fused(fused)

        tkv_specs = serve_rt.tiered_kv_state_specs(mesh, parallel, bsz, cold_pages)
        in_specs = (p_specs, P(bax, None), tkv_specs, ssm_specs)
        return Cell(arch, shape_name, "tiered_decode", fn, in_specs,
                    (params_shape, tok, tkv, ssm_sds), mesh,
                    notes + f" tiered_kv pages={n_pages} pt={page_tokens}",
                    donate=(2, 3), out_specs=(P(bax, None, None), tkv_specs, ssm_specs, None))

    # Dense-cache decode (or SSM-state decode), the cache padded past seq_len.
    max_len = shape.seq_len + 64
    with abstract():
        state = model.init_cache(bsz, max_len)
    s_specs = shr.decode_state_specs(cfg, mesh, parallel, bsz, max_len)

    def step(params, token, state):
        return model.decode_step(params, token, state)

    return Cell(arch, shape_name, "decode", step, (p_specs, P(bax, None), s_specs),
                (params_shape, tok, state), mesh, notes, donate=(2,),
                out_specs=(P(bax, None, None), s_specs))
