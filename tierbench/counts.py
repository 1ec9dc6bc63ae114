"""Operations and bytes of the work the cells drive, from shapes and the
cache's page counts: the numerators of the roofline and mfu metrics.

Every input byte is counted once and every output byte once, whatever a
kernel reads again; attention counts only the pages, rows and slots that
hold live tokens. ``conf`` is a configuration file (``configs/<name>.json``,
Hugging Face key names)."""

from __future__ import annotations

import dataclasses

import numpy as np

BF16, F32, I32 = 2, 4, 4


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv: int
    hd: int
    ff: int
    vocab: int
    qkv_bias: bool
    qk_norm: bool


def dims(conf: dict) -> Dims:
    heads = conf["num_attention_heads"]
    return Dims(layers=conf["num_hidden_layers"], d=conf["hidden_size"], heads=heads,
                kv=conf["num_key_value_heads"],
                hd=conf.get("head_dim") or conf["hidden_size"] // heads,
                ff=conf["intermediate_size"], vocab=conf["vocab_size"],
                qkv_bias=bool(conf.get("attention_bias", False)),
                qk_norm=bool(conf.get("qk_norm", False)))


def linear_params(m: Dims) -> int:
    """Matmul weights of one layer: q, k, v, o and the gated FFN."""
    return m.d * (m.heads + 2 * m.kv) * m.hd + m.heads * m.hd * m.d + 3 * m.d * m.ff


def weight_bytes(m: Dims) -> int:
    """Bytes a forward reads of weights: every layer (bf16 matmuls and
    biases, f32 norms) and the output head; embedding rows are counted per
    token by the callers."""
    per_layer = linear_params(m) * BF16 + 2 * m.d * F32
    if m.qkv_bias:
        per_layer += (m.heads + 2 * m.kv) * m.hd * BF16
    if m.qk_norm:
        per_layer += 2 * m.hd * F32
    return m.layers * per_layer + m.d * F32 + m.d * m.vocab * BF16


def prefill(m: Dims, s: int):
    """(FLOPs, bytes) of one prefill of ``s`` tokens: the matmuls, causal
    attention (QK and PV over s(s+1)/2 pairs a head), the head at the last
    position; weights and the prompt's embedding rows."""
    flops = 2 * s * m.layers * linear_params(m)
    flops += m.layers * 4 * m.heads * m.hd * s * (s + 1) // 2
    flops += 2 * m.d * m.vocab
    return flops, weight_bytes(m) + s * m.d * BF16


def page_bytes(m: Dims, pt: int, bits: int) -> int:
    """Payload and f32 scales of one page (K and V) at ``bits``."""
    return 2 * pt * m.kv * (m.hd * bits // 8 + F32)


def decode_step(m: Dims, slots: int, keys: int, kv_bytes: int):
    """(FLOPs, bytes) of one decode step over ``slots`` batch rows, with
    ``keys`` attended keys summed over layers and active slots and
    ``kv_bytes`` of cache read (pages with scales, the recent window)."""
    flops = 2 * slots * (m.layers * linear_params(m) + m.d * m.vocab)
    flops += 4 * m.heads * m.hd * keys
    return flops, weight_bytes(m) + slots * m.d * BF16 + kv_bytes


def attention_step_bytes(m: Dims, pt: int, warm_bits: int, cold_bits: int,
                         n_warm: np.ndarray, n_cold: np.ndarray, n_host: np.ndarray,
                         recent: np.ndarray) -> int:
    """Bytes the fused tiered attention kernel needs over all layers of one
    step, for the active slots: ``n_warm``, ``n_cold``, ``n_host`` [layers,
    slots] page counts, ``recent`` [slots] live recent-window rows (the new
    token included). In: q (bf16), the device pages with scales, the host
    sentinel centroids (f32), the recent rows (bf16 K and V), the unified
    page table (slot and tier, int32) and the window lengths. Out: the
    output (f32), m and l (f32), the page mass and base (f32) of each live
    row."""
    slots = recent.size
    rows = n_warm + n_cold + n_host
    per_layer_in = (slots * m.heads * m.hd * BF16 + slots * I32
                    + 2 * (recent.sum() * m.kv * m.hd * BF16))
    total = m.layers * per_layer_in
    total += int(n_warm.sum()) * page_bytes(m, pt, warm_bits)
    total += int(n_cold.sum()) * page_bytes(m, pt, cold_bits)
    total += int(n_host.sum()) * m.kv * m.hd * F32
    total += int(rows.sum()) * 2 * I32
    total += m.layers * slots * (m.heads * m.hd * F32 + 2 * m.heads * F32)
    total += int(rows.sum()) * 2 * F32
    return int(total)


def quant_bytes(m: Dims, pt: int, pages: int, bits: int) -> int:
    """Bytes of the page-out quantization of ``pages`` pages (K and V): bf16
    in, codes and f32 scales out."""
    return pages * 2 * pt * m.kv * m.hd * BF16 + pages * page_bytes(m, pt, bits)
