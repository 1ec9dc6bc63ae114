"""Elastic scaling + failure handling for multi-pod runs, after
``repro.runtime.elastic`` (pure Python and numpy, copied).

Failure model (what a 1000+-node deployment actually sees):
  * a host/chip drops -> the collective times out -> the job controller
    kills the step, reforms the mesh from survivors, restores the last
    committed checkpoint, and resumes;
  * capacity returns -> scale back up at the next window boundary.

What lives here:
  * ``plan_remesh``: given surviving device count and the parallel config,
    pick the largest legal (pod, data, model) mesh <= survivors, keeping the
    model axis intact (TP degree is baked into weight layouts; shrinking DP
    is free, shrinking TP requires resharding weights — we keep TP fixed and
    shed data-parallel replicas, the standard elastic policy);
  * ``rebalance_batch``: recompute per-shard batch so the global batch is
    preserved (grad-accum absorbs the lost replicas);
  * ``ElasticRunner``: drives step -> detect -> remesh -> restore -> resume.
    Failures are injected by tests/examples via ``fail_hook``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    grad_accum: int  # multiplier to preserve global batch

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


def plan_remesh(
    n_devices: int,
    model_parallel: int,
    global_batch: int,
    microbatch_per_replica: int,
    multi_pod_size: Optional[int] = None,
) -> MeshPlan:
    """Largest legal mesh from ``n_devices`` survivors with TP fixed.

    DP replicas = floor(n / (tp * pod)); grad_accum scales so that
    dp * accum * microbatch == global_batch stays invariant.
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {n_devices} devices; "
            "weight resharding required (full restart path)"
        )
    pods = multi_pod_size or 1
    per_pod = n_devices // pods
    dp = max(per_pod // model_parallel, 1)
    used_replicas = dp * pods
    need = global_batch // microbatch_per_replica
    accum = max(int(math.ceil(need / used_replicas)), 1)
    if pods > 1:
        return MeshPlan((pods, dp, model_parallel), ("pod", "data", "model"), accum)
    return MeshPlan((dp, model_parallel), ("data", "model"), accum)


def rebalance_batch(global_batch: int, plan: MeshPlan) -> int:
    replicas = plan.n_devices // plan.shape[-1]
    per = global_batch // (replicas * plan.grad_accum)
    return max(per, 1)


class ElasticRunner:
    """Step-loop wrapper: run, detect injected failures, remesh, restore.

    The controller is deliberately synchronous and host-driven — the same
    structure a GKE/Borg job controller imposes; tests inject failures via
    ``fail_hook(step) -> surviving_device_count | None``.
    """

    def __init__(
        self,
        build_step: Callable[[MeshPlan], Callable],  # returns step_fn(state, batch)
        save_fn: Callable[[int, dict], None],
        restore_fn: Callable[[], Tuple[int, dict]],
        initial_plan: MeshPlan,
        checkpoint_every: int = 50,
        fail_hook: Optional[Callable[[int], Optional[int]]] = None,
        model_parallel: int = 1,
        global_batch: int = 8,
        microbatch_per_replica: int = 1,
    ):
        self.build_step = build_step
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.plan = initial_plan
        self.checkpoint_every = checkpoint_every
        self.fail_hook = fail_hook
        self.model_parallel = model_parallel
        self.global_batch = global_batch
        self.microbatch_per_replica = microbatch_per_replica
        self.remesh_events = []

    def run(self, state: dict, batches, n_steps: int, start_step: int = 0):
        step_fn = self.build_step(self.plan)
        step = start_step
        it = iter(batches)
        while step < n_steps:
            if self.fail_hook is not None:
                survivors = self.fail_hook(step)
                if survivors is not None:
                    # Failure: reform mesh, restore last checkpoint, resume.
                    new_plan = plan_remesh(
                        survivors,
                        self.model_parallel,
                        self.global_batch,
                        self.microbatch_per_replica,
                        multi_pod_size=None,
                    )
                    self.remesh_events.append((step, self.plan, new_plan))
                    self.plan = new_plan
                    step_fn = self.build_step(new_plan)
                    step, state = self.restore_fn()
                    continue
            batch = next(it)
            state = step_fn(state, batch)
            step += 1
            if step % self.checkpoint_every == 0:
                self.save_fn(step, state)
        return step, state
