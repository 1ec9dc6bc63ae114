"""Seeded random weights, made on the device in the type they are served in.

One ``torch.Generator`` on the card fills a single flat bf16 buffer with
standard normals, in chunks of at most 2**30 elements; every matrix is a
view of that buffer scaled in place by its fan-in (``1/sqrt(fan_in)``; the
embedding and the biases by 0.02). Norm weights are f32, ``1 + 0.1 N(0, 1)``
from the same generator, so that a norm's weight counts in what is served.
The same seed gives the same weights.

The tree is the layout ``repro_torch.models.Model`` takes (layer-stacked,
``[layers, ...]``), which is also the layout the plain reference reads:

    embed [V, d]; lm_head [d, V]; final_norm [d] f32
    blocks.norm1, blocks.norm2 [L, d] f32
    blocks.attn.wq [L, d, H, hd]; wk, wv [L, d, KV, hd]; wo [L, H, hd, d]
    blocks.attn.bq [L, H, hd]; bk, bv [L, KV, hd]    (attention_bias)
    blocks.attn.q_norm, k_norm [L, hd] f32           (qk_norm)
    blocks.ffn.w_gate, w_up [L, d, ff]; w_down [L, ff, d]
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from tierbench.counts import dims

CHUNK = 1 << 30


def _layout(conf: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    m = dims(conf)
    L, d, H, KV, hd, ff, V = m.layers, m.d, m.heads, m.kv, m.hd, m.ff, m.vocab
    out = [
        (("embed",), (V, d), 0.02),
        (("lm_head",), (d, V), d ** -0.5),
        (("blocks", "attn", "wq"), (L, d, H, hd), d ** -0.5),
        (("blocks", "attn", "wk"), (L, d, KV, hd), d ** -0.5),
        (("blocks", "attn", "wv"), (L, d, KV, hd), d ** -0.5),
        (("blocks", "attn", "wo"), (L, H, hd, d), (H * hd) ** -0.5),
        (("blocks", "ffn", "w_gate"), (L, d, ff), d ** -0.5),
        (("blocks", "ffn", "w_up"), (L, d, ff), d ** -0.5),
        (("blocks", "ffn", "w_down"), (L, ff, d), ff ** -0.5),
    ]
    if m.qkv_bias:
        out += [(("blocks", "attn", "bq"), (L, H, hd), 0.02),
                (("blocks", "attn", "bk"), (L, KV, hd), 0.02),
                (("blocks", "attn", "bv"), (L, KV, hd), 0.02)]
    return out


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(conf: dict, seed: int, device) -> Dict:
    """The weight tree of ``conf`` from ``seed``, on ``device``."""
    m = dims(conf)
    layout = _layout(conf)
    total = sum(torch.Size(shape).numel() for _, shape, _ in layout)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    for lo in range(0, total, CHUNK):
        flat[lo:lo + CHUNK].normal_(generator=gen)
    tree: Dict = {}
    at = 0
    for path, shape, std in layout:
        n = torch.Size(shape).numel()
        _put(tree, path, flat[at:at + n].view(shape).mul_(std))
        at += n

    norms = [(("final_norm",), (m.d,)), (("blocks", "norm1"), (m.layers, m.d)),
             (("blocks", "norm2"), (m.layers, m.d))]
    if m.qk_norm:
        norms += [(("blocks", "attn", "q_norm"), (m.layers, m.hd)),
                  (("blocks", "attn", "k_norm"), (m.layers, m.hd))]
    flat = torch.empty(sum(torch.Size(s).numel() for _, s in norms), dtype=torch.float32,
                       device=device).normal_(generator=gen).mul_(0.1).add_(1.0)
    at = 0
    for path, shape in norms:
        n = torch.Size(shape).numel()
        _put(tree, path, flat[at:at + n].view(shape))
        at += n
    return tree
