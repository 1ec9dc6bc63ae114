"""The dense decoder family: in every layer a pre-norm block of attention
(GQA, optional QKV biases and per-head qk-norm) and a gated SwiGLU FFN,
RMSNorm throughout (Qwen1.5, Qwen3). Hugging Face key names.

The weight tree is the layout ``repro_torch.models.Model`` takes
(layer-stacked, ``[layers, ...]``), which is also the layout the plain
reference reads:

    embed [V, d]; lm_head [d, V]; final_norm [d] f32
    blocks.norm1, blocks.norm2 [L, d] f32
    blocks.attn.wq [L, d, H, hd]; wk, wv [L, d, KV, hd]; wo [L, H, hd, d]
    blocks.attn.bq [L, H, hd]; bk, bv [L, KV, hd]    (attention_bias)
    blocks.attn.q_norm, k_norm [L, hd] f32           (qk_norm)
    blocks.ffn.w_gate, w_up [L, d, ff]; w_down [L, ff, d]

Matrices are scaled by their fan-in (``1/sqrt(fan_in)``; the embedding and
the biases by 0.02).

The counts count every input byte once and every output byte once; a
forward reads every layer's weights (bf16 matmuls and biases, f32 norms)
and the output head, and embedding rows per token.
"""

from __future__ import annotations

import dataclasses

import torch

from tierbench.counts import BF16, F32
from tierbench.families import NORM, Shape


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


def model_config(conf: dict):
    from repro_torch.configs.base import ModelConfig

    m = dims(conf)
    return ModelConfig(name=conf["name"], family=conf["family"], n_layers=m.layers, d_model=m.d,
                       n_heads=m.heads, n_kv_heads=m.kv, d_ff=m.ff, vocab_size=m.vocab,
                       head_dim=m.hd, qk_norm=m.qk_norm, qkv_bias=m.qkv_bias,
                       rope_theta=float(conf["rope_theta"]),
                       norm_eps=float(conf["rms_norm_eps"]), act="swiglu",
                       tie_embeddings=bool(conf.get("tie_word_embeddings", False)))


def weight_layout(conf: dict):
    m = dims(conf)
    L, d, H, KV, hd, ff, V = m.layers, m.d, m.heads, m.kv, m.hd, m.ff, m.vocab
    bf16, f32 = torch.bfloat16, torch.float32
    out = [
        (("embed",), (V, d), bf16, 0.02),
        (("lm_head",), (d, V), bf16, d ** -0.5),
        (("blocks", "attn", "wq"), (L, d, H, hd), bf16, d ** -0.5),
        (("blocks", "attn", "wk"), (L, d, KV, hd), bf16, d ** -0.5),
        (("blocks", "attn", "wv"), (L, d, KV, hd), bf16, d ** -0.5),
        (("blocks", "attn", "wo"), (L, H, hd, d), bf16, (H * hd) ** -0.5),
        (("blocks", "ffn", "w_gate"), (L, d, ff), bf16, d ** -0.5),
        (("blocks", "ffn", "w_up"), (L, d, ff), bf16, d ** -0.5),
        (("blocks", "ffn", "w_down"), (L, ff, d), bf16, ff ** -0.5),
    ]
    if m.qkv_bias:
        out += [(("blocks", "attn", "bq"), (L, H, hd), bf16, 0.02),
                (("blocks", "attn", "bk"), (L, KV, hd), bf16, 0.02),
                (("blocks", "attn", "bv"), (L, KV, hd), bf16, 0.02)]
    out += [(("final_norm",), (d,), f32, NORM), (("blocks", "norm1"), (L, d), f32, NORM),
            (("blocks", "norm2"), (L, d), f32, NORM)]
    if m.qk_norm:
        out += [(("blocks", "attn", "q_norm"), (L, hd), f32, NORM),
                (("blocks", "attn", "k_norm"), (L, hd), f32, NORM)]
    return out


def shape(conf: dict) -> Shape:
    m = dims(conf)
    return Shape(layers=m.layers, heads=m.heads, kv=m.kv, hd=m.hd)


def linear_params(m: Dims) -> int:
    """Matmul weights of one layer: q, k, v, o and the gated FFN."""
    return m.d * (m.heads + 2 * m.kv) * m.hd + m.heads * m.hd * m.d + 3 * m.d * m.ff


def weight_bytes(conf: dict) -> int:
    m = dims(conf)
    per_layer = linear_params(m) * BF16 + 2 * m.d * F32
    if m.qkv_bias:
        per_layer += (m.heads + 2 * m.kv) * m.hd * BF16
    if m.qk_norm:
        per_layer += 2 * m.hd * F32
    return m.layers * per_layer + m.d * F32 + m.d * m.vocab * BF16


def prefill(conf: dict, s: int):
    """The matmuls, causal attention (QK and PV over s(s+1)/2 pairs a head),
    the head at the last position; weights and the prompt's embedding
    rows."""
    m = dims(conf)
    flops = 2 * s * m.layers * linear_params(m)
    flops += m.layers * 4 * m.heads * m.hd * s * (s + 1) // 2
    flops += 2 * m.d * m.vocab
    return flops, weight_bytes(conf) + s * m.d * BF16


def decode_step(conf: dict, slots: int, keys: int, kv_bytes: int):
    m = dims(conf)
    flops = 2 * slots * (m.layers * linear_params(m) + m.d * m.vocab)
    flops += 4 * m.heads * m.hd * keys
    return flops, weight_bytes(conf) + slots * m.d * BF16 + kv_bytes
