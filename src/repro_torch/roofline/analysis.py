"""Three-term roofline of a counted cell on the H100, after
``repro.roofline.analysis``:

    compute    = FLOPs / (chips * peak bf16 FLOP/s)
    memory     = bytes / (chips * HBM bandwidth)
    collective = 0 on one chip

FLOPs and bytes come from ``op_stats`` (counted at dispatch, every loop trip
included); the device's figures are the H100 SXM5's from NVIDIA's data
sheet (dense bf16 tensor-core peak, HBM3 bandwidth, at its 700 W limit),
and its HBM capacity is the card's own where a card is present. The
reference divides by a TPU's figures (``core.hw.V5E``); none of them reach
this module. XLA's per-device temp bytes, the HLO collective bytes and the
CPU-backend upcast artifact have no eager counterpart and are not reported.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_bf16_flops: float  # dense tensor-core FLOP/s
    hbm_bw: float  # bytes/s
    hbm_bytes: float


# NVIDIA H100 SXM5 80GB data sheet: 989.4 TFLOP/s dense bf16 (1979 with
# sparsity), 3.35 TB/s HBM3, 80 GB.
H100 = DeviceSpec("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12, 80e9)


def device_spec() -> DeviceSpec:
    """The H100's figures, with the card's own HBM capacity and name when a
    card is present."""
    if not torch.cuda.is_available():
        return H100
    props = torch.cuda.get_device_properties(0)
    return dataclasses.replace(H100, name=props.name, hbm_bytes=float(props.total_memory))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    device: str
    # per-device
    flops_pd: float
    bytes_pd: float
    coll_bytes_pd: float
    coll_by_kind: Dict[str, float]
    # seconds
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    # memory feasibility: the arguments alone (no eager temp-bytes counterpart)
    args_bytes_pd: float
    fits_hbm: bool
    # usefulness
    model_flops: float  # 6*N*D (train) / 2*N*D (inference) — global
    counted_flops_global: float
    useful_ratio: float
    peak_bf16_flops: float
    notes: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful FLOP/s at the modeled step time over the peak."""
        if self.step_time_s <= 0:
            return 0.0
        return self.model_flops / self.chips / self.step_time_s / self.peak_bf16_flops


def analyze(
    flops_pd: float,
    bytes_pd: float,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    model_flops: float,
    args_bytes_pd: float,
    notes: str = "",
) -> RooflineReport:
    """The report of a cell whose per-device FLOPs and bytes were counted
    (``op_stats.analyze``); the counterpart of ``analyze_compiled``."""
    spec = device_spec()
    compute_s = flops_pd / spec.peak_bf16_flops
    memory_s = bytes_pd / spec.hbm_bw
    collective_s = 0.0
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    counted_global = flops_pd * chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips, device=spec.name,
        flops_pd=flops_pd, bytes_pd=bytes_pd, coll_bytes_pd=0.0, coll_by_kind={"total": 0.0},
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        args_bytes_pd=args_bytes_pd, fits_hbm=args_bytes_pd <= spec.hbm_bytes,
        model_flops=model_flops, counted_flops_global=counted_global,
        useful_ratio=(model_flops / counted_global) if counted_global else 0.0,
        peak_bf16_flops=spec.peak_bf16_flops, notes=notes,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for inference steps.

    N = active params (MoE counts routed experts only). D = tokens processed
    by one step: global_batch*seq for train/prefill, global_batch for decode
    (one token each), plus decode attention's reads of the KV cache.
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    d = shape.global_batch
    flops = 2.0 * n * d
    if cfg.has_attention:
        # QK and PV: 2*2*kv*hd per cached token per layer and head group.
        la = cfg.n_layers if cfg.family != "hybrid" else -(-cfg.n_layers // cfg.hybrid_attn_every)
        kvdim = cfg.n_kv_heads * cfg.head_dim_()
        flops += 4.0 * d * shape.seq_len * kvdim * la * (cfg.n_heads // max(cfg.n_kv_heads, 1))
    return flops


def save_report(report: RooflineReport, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=2)
