"""Model/arch configuration schema.

One ``ModelConfig`` fully describes an architecture; ``src/repro/configs/<id>.py``
files instantiate the architectures (full scale) plus reduced smoke
variants; ``TierScapeRunConfig`` carries the TierScape settings of a run.
Field for field the same as ``repro.configs.base``, so both packages build
from equal configurations.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple


def _default_async_migration() -> bool:
    """Default for ``TierScapeRunConfig.async_migration``: True (the async
    media pipeline, equivalence-tested and perf-guarded in the reference,
    is the default path). ``REPRO_ASYNC_MIGRATION=0`` is the escape hatch back
    to the blocking window-boundary oracle; the nightly soak job exports
    ``REPRO_ASYNC_MIGRATION=1`` to force the async path explicitly."""
    v = os.environ.get("REPRO_ASYNC_MIGRATION", "1").strip().lower()
    return v not in ("0", "false", "off")


def _default_faults() -> bool:
    """Default for ``TierScapeRunConfig.faults``: False — fault injection is
    opt-in, unlike async/prefetch. ``REPRO_FAULTS=1`` (the nightly chaos
    soak) wires the default transient+corruption ``FaultPlan`` into every
    engine: those fault kinds are fully recovered and billing-neutral, so
    tier-1 expectations hold unchanged while the retry and CRC-repair paths
    run hot underneath."""
    v = os.environ.get("REPRO_FAULTS", "0").strip().lower()
    return v in ("1", "true", "on")


def _default_prefetch() -> bool:
    """Default for ``TierScapeRunConfig.prefetch``: True — the predictor is
    now fed in-engine (the fused decode kernel's host-page would-have-
    touched mass flows straight into ``prefetch_candidates``), closing the
    ROADMAP soak condition; placements stay bit-identical to a prefetch-free
    run by construction, so the flip is purely a latency win.
    ``REPRO_PREFETCH=0`` is the escape hatch, mirroring
    ``REPRO_ASYNC_MIGRATION``. Prefetch still requires the async path: with
    ``async_migration`` disabled the cache quietly ignores it."""
    v = os.environ.get("REPRO_PREFETCH", "1").strip().lower()
    return v not in ("0", "false", "off")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # dbrx-style fine-grained: experts formed by splitting wider FFNs. We
    # model the published (n_experts, top_k, d_ff) directly.


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128  # SSD chunk length
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # Attention flavor.
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False  # qwen2-vl multimodal 3-axis RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    causal: bool = True
    # FFN flavor.
    act: str = "swiglu"  # swiglu | gelu
    # Mixture of experts (family == "moe"): dense d_ff unused if 0.
    moe: Optional[MoEConfig] = None
    # State space (family in {"ssm","hybrid"}).
    ssm: Optional[SSMConfig] = None
    # Hybrid (zamba2): one shared attention+MLP block applied every k layers.
    hybrid_attn_every: int = 0
    # Modality frontend stub: inputs are precomputed frame/patch embeddings
    # instead of token ids ("audio" | "vision" | None).
    frontend: Optional[str] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # Norm style: "rmsnorm" | "layernorm" (hubert uses LN).
    norm: str = "rmsnorm"

    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.head_dim_()
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.qkv_bias:
            attn += n_q + 2 * n_kv
        if self.act == "swiglu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        per_layer = 0
        if self.family in ("dense", "encoder", "vlm"):
            per_layer = attn + ffn
            total = self.n_layers * per_layer
        elif self.family == "moe":
            m = self.moe
            ffn_e = 3 * d * m.d_ff_expert if self.act == "swiglu" else 2 * d * m.d_ff_expert
            router = d * m.n_experts
            total = self.n_layers * (attn + m.n_experts * ffn_e + router)
        elif self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj (z,x,B,C,dt) + out_proj + conv
            in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            total = self.n_layers * (in_proj + di * d + s.conv_kernel * (di + 2 * s.n_groups * s.d_state))
        elif self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            mamba = self.n_layers * (in_proj + di * d + s.conv_kernel * (di + 2 * s.n_groups * s.d_state))
            shared = attn + ffn  # one shared transformer block
            total = mamba + shared
        else:
            raise ValueError(self.family)
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings and self.is_decoder:
            total += self.vocab_size * d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        ffn_e = 3 * d * m.d_ff_expert if self.act == "swiglu" else 2 * d * m.d_ff_expert
        inactive = self.n_layers * (m.n_experts - m.experts_per_token) * ffn_e
        return int(self.param_count() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the (pod, data, model) mesh, the reference's
    fields. The port runs on one device, where only ``remat`` (checkpoint
    each layer: less activation memory, the same numbers) and
    ``grad_accum`` act. ``fsdp``, ``scan_layers``, ``shard_kv_seq`` and
    ``grad_compress_pods`` are accepted and do nothing, as on the
    reference's 1-device mesh (the port's layers always run as a loop)."""

    fsdp: bool = False  # shard params/opt-state over the data axis too
    remat: str = "block"  # "none" | "block" (checkpoint each layer)
    scan_layers: bool = True
    # Sequence-parallel KV sharding for decode (long context).
    shard_kv_seq: bool = False
    # Gradient compression for the cross-pod reduce (int8 + error feedback).
    grad_compress_pods: bool = False
    # Microbatching (gradient accumulation steps).
    grad_accum: int = 1


@dataclasses.dataclass(frozen=True)
class TierScapeRunConfig:
    """TierScape engagement for a run."""

    enabled: bool = False
    policy: str = "analytical"  # waterfall | analytical | 2t
    alpha: float = 0.5
    hotness_threshold: float = 8.0
    window_steps: int = 64
    kv_page_tokens: int = 64  # tokens per managed KV page
    # Device-resident tier pair used inside the jitted serve step.
    warm_tier: str = "C1"
    cold_tier: str = "C9"
    # Backing-media subsystem: route window migration plans through the
    # async double-buffered pipeline (non-blocking window boundaries) and
    # size its pinned staging ring. Defaults on (env-overridable, see
    # ``_default_async_migration``); off = blocking migrate_batch (the
    # equivalence oracle).
    async_migration: bool = dataclasses.field(
        default_factory=_default_async_migration
    )
    media_ring_slots: int = 64
    # Speculative prefetch/readahead on the media pipeline: mid-window,
    # host-resident pages whose access rate is rising toward the promotion
    # frontier are staged through a reserved slice of the pinned ring so a
    # window-boundary promotion commits without paying the swap-in read.
    # Requires the async pipeline; placements stay bit-identical to a
    # prefetch-free run (speculation hides latency, never changes policy).
    # Defaults on now that the fused decode kernel feeds the predictor
    # in-engine (env-overridable, see ``_default_prefetch``).
    prefetch: bool = dataclasses.field(default_factory=_default_prefetch)
    prefetch_max_pages: int = 8
    # Codec widths (8 or 4) of the device pools. Pools of equal width share
    # one codec-class payload buffer (class-major storage): the fused decode
    # step reads them with zero per-step concatenation and same-class
    # migrations are pure page-table edits. The (8, 4) default reproduces
    # the classic int8-warm / int4-cold split.
    warm_bits: int = 8
    cold_bits: int = 4
    # Backing device for the host tiers ("" = host_dram_pcie; "cxl_hw"
    # rebinds them onto the hardware-compressed CXL expander).
    host_media_device: str = ""
    # Deterministic fault injection (media/faults.py). ``faults`` arms it;
    # with no explicit ``fault_plan`` the engine synthesizes the default
    # transient+corruption plan on the host media device. Defaults off
    # (env-overridable via REPRO_FAULTS, see ``_default_faults``).
    faults: bool = dataclasses.field(default_factory=_default_faults)
    fault_plan: Optional[Any] = None
