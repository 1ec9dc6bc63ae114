"""Train-step builder, after ``repro.runtime.train``: loss -> grad ->
AdamW or tiered-AdamW update, with microbatch gradient accumulation, on one
device.

The forward and backward run under ``torch.autograd``, with gradients in
the parameters' dtypes. The step updates ``params`` and the optimizer state
in place and returns them: the reference's jitted step donates both, and a
full-width model and its moments fit on one card only without a second
copy.

The reference's ``TrainStep`` also carries the in/out sharding specs and
the mesh that ``pjit`` lowers the step with. One device has no shardings,
so the port's ``TrainStep`` keeps only ``fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import pytree
from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, tiered_adam
from repro_torch.optim.adamw import AdamWConfig

PyTree = Any


@dataclasses.dataclass
class TrainStep:
    fn: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)


def value_and_grad(model: Model, params: PyTree, batch: Dict[str, torch.Tensor]):
    """``model.loss`` and its gradient with respect to every leaf of
    ``params``: (loss, metrics, grads), grads in the leaves' dtypes (zeros
    for a leaf the loss does not read, as JAX gives)."""
    flat = pytree.leaves(params)
    req = [p.detach().requires_grad_(True) for p in flat]
    loss, metrics = model.loss(pytree.unflatten(params, req), batch)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            pytree.unflatten(params, grads))


def microbatches(batch: Dict[str, torch.Tensor], accum: int) -> list:
    """``accum`` microbatches, split along the batch axis: axis 1 of the
    [3, B, S] M-RoPE positions, axis 0 of everything else."""
    split = {}
    for k, v in batch.items():
        if k == "positions" and v.dim() == 3 and v.shape[0] == 3:
            split[k] = v.reshape(3, accum, v.shape[1] // accum, *v.shape[2:]).transpose(0, 1)
        else:
            split[k] = v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    parallel: ParallelConfig,
    batch_example: Dict[str, torch.Tensor],
    tiered_policy: Optional[dict] = None,
) -> TrainStep:
    """The step for ``model``: AdamW, or tiered Adam when a
    ``tiered_policy`` is given (the state then comes from
    ``tiered_adam.init(params, tiered_policy)``). ``parallel.grad_accum``
    microbatches must divide ``batch_example``'s batch."""
    accum = parallel.grad_accum
    bsz = int(pytree.leaves(batch_example)[0].shape[0])
    if accum > 1 and bsz % accum:
        raise ValueError(f"batch {bsz} does not split into {accum} microbatches")
    update = tiered_adam.update if tiered_policy is not None else adamw.update

    def compute_grads(params, batch):
        if accum <= 1:
            return value_and_grad(model, params, batch)
        # Microbatch accumulation: grads summed in f32, then the mean.
        g_acc, loss_sum = None, None
        for mb in microbatches(batch, accum):
            loss, _, g = value_and_grad(model, params, mb)
            flat = [x.to(torch.float32) for x in pytree.leaves(g)]
            del g
            if g_acc is None:  # the first microbatch's (0 + g is g)
                g_acc, loss_sum = flat, loss
            else:
                for a, x in zip(g_acc, flat):
                    a.add_(x)
                loss_sum = loss_sum + loss
        loss = loss_sum / accum
        return loss, {"loss": loss}, pytree.unflatten(params, [a / accum for a in g_acc])

    def step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, batch)
        params, opt_state, om = update(grads, opt_state, params, opt_cfg)
        return params, opt_state, dict(metrics, **om)

    return TrainStep(fn=step)
