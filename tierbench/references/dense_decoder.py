"""Plain reference of a dense decoder served through a tiered, quantized KV
cache: the Qwen1.5 / Qwen3 architecture (Hugging Face ``Qwen2ForCausalLM``,
``Qwen3ForCausalLM``), written from the published description in plain
PyTorch and float32 with TF32 off. It imports nothing of the program.

Model: token embedding; per layer a pre-norm block, RMSNorm (``x *
rsqrt(mean(x^2) + eps) * w``), q/k/v projections (with biases under
``attention_bias``), per-head RMSNorm of q and k (``qk_norm``), rotary
embedding on the two halves of each head (``rotate_half``, base
``rope_theta``), softmax attention with ``num_key_value_heads`` groups, the
output projection, a residual, a second RMSNorm and the gated FFN
``down(silu(gate(x)) * up(x))``; a final RMSNorm and the output head.

Serving semantics (the configuration's ``tiering``): a request's prompt is
prefilled with exact causal attention, and its first token comes from the
last prompt position. Each later token is decoded against the request's
cache: the keys and values of full pages that have left the dense recent
window are held quantized, and only pages resident on the device are read;
the recent window (every token from the first unpaged one to the new token)
is read densely. The cache holds keys and values in bf16; a page is
quantized from its bf16 values (per token and KV head, scale = absmax / QMAX,
1 where the row is 0, codes = round-half-even(x / scale) clamped to +-QMAX,
QMAX 127 for int8 and 7 for int4), and a page that moves between codec
widths is requantized from its dequantized values.

Which page is where at each step is the placement policy's decision, which
this reference follows: ``bits[j, l, p]`` is the codec width page ``p`` of
layer ``l`` holds at decode step ``j`` (0 where the page does not exist yet,
the recent window then starting at the first such page) and ``read[j, l,
p]`` whether it is on the device (read by attention) at that step.

Each decode step also gives each page's share of the step's attention: the
softmax weights of the page's tokens summed over every head, over the
weights of every key summed over every head, where each head's weights are
taken at the step's largest score (``exp(s - max)``), so that a head with
a larger partition function weighs more. That is the mass a hotness
telemetry reports.

``precision="fp8"`` is the control: every matmul of the model (projections,
FFN, head) takes float8 e4m3 inputs, activations scaled per row and weights
per output column, accumulated in float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

QMAX = {8: 127.0, 4: 7.0}
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Linear:
    def __init__(self, precision: str):
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [T, in] f32, w [in, out] (any float type)."""
        w = w.to(torch.float32)
        if self.precision == "fp8":
            return _fp8(x, 1) @ _fp8(w, 0)
        return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.to(torch.float32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions pos [T]."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.to(torch.float32)[:, None] * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def qdq(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize to ``bits`` and back, per row of the last dim."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / QMAX[bits])
    return torch.clamp(torch.round(x / scale), -QMAX[bits], QMAX[bits]) * scale


def _causal(q, k, v):
    """q [S, KV, g, hd] (scaled), k/v [S, KV, hd] -> [S, KV*g*hd]."""
    s = torch.einsum("qkgh,tkh->kgqt", q, k)
    n = q.shape[0]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("kgqt,tkh->qkgh", w, v).reshape(n, -1)


def _page_versions(kb: torch.Tensor, widths: np.ndarray, pt: int):
    """Values of each page through its codec chain. kb [T, KV, hd] bf16-valued
    f32; widths [m, P] codec width per step (0: no page). Returns (versions
    [C, P, pt, KV, hd], chain [m, P] index into the versions)."""
    m, p = widths.shape
    prev = np.zeros(p, np.int64)
    chain = np.zeros((m, p), np.int64)
    seq = [[] for _ in range(p)]
    for j in range(m):
        w = widths[j]
        for i in np.nonzero((w != 0) & (w != prev))[0]:
            seq[i].append(int(w[i]))
        prev = np.where(w != 0, w, prev)
        chain[j] = [max(len(s) - 1, 0) for s in seq]
    depth = max((len(s) for s in seq), default=0)
    pages = kb[: p * pt].reshape(p, pt, *kb.shape[1:])
    versions, cur = [], pages
    for c in range(max(depth, 1)):
        w = torch.tensor([s[c] if c < len(s) else 8 for s in seq], device=kb.device)
        cur = torch.where((w == 8)[:, None, None, None], qdq(cur, 8), qdq(cur, 4))
        versions.append(cur)
    return torch.stack(versions), chain


def _tiered(q, kb, vb, widths, read, s, pt):
    """Decode queries q [m, KV, g, hd] (scaled) at positions s .. s+m-1
    against the tiered cache. kb/vb [T, KV, hd]; widths, read [m, P].
    Returns the attention output [m, KV*g*hd] and each page's share of the
    step's attention mass [m, P] (the module docstring)."""
    m, kv, g, hd = q.shape
    p = widths.shape[1]
    dev = q.device
    paged = (widths != 0).sum(axis=1)  # pages out of the recent window, per step
    kver, chain = _page_versions(kb, widths, pt)
    vver, _ = _page_versions(vb, widths, pt)
    chain_t = torch.as_tensor(chain, device=dev)
    live = torch.as_tensor(read & (widths != 0), device=dev)  # [m, P]
    sp = torch.zeros(m, kv, g, p, pt, device=dev)
    for c in range(kver.shape[0]):
        sc = torch.einsum("mkgh,ptkh->mkgpt", q, kver[c])
        sp = torch.where((chain_t == c)[:, None, None, :, None], sc, sp)
    sp = sp.masked_fill(~live[:, None, None, :, None], float("-inf")).reshape(m, kv, g, p * pt)
    t = kb.shape[0]
    sr = torch.einsum("mkgh,tkh->mkgt", q, kb)
    pos = torch.arange(t, device=dev)[None]
    lo = torch.as_tensor(paged * pt, device=dev)[:, None]
    hi = (s + torch.arange(m, device=dev))[:, None]
    sr = sr.masked_fill(~((pos >= lo) & (pos <= hi))[:, None, None, :], float("-inf"))
    sc = torch.cat([sp, sr], dim=-1)
    w = torch.softmax(sc, dim=-1)
    e = torch.exp(sc - sc.amax(dim=(1, 2, 3), keepdim=True))
    hot = e[..., : p * pt].reshape(m, kv, g, p, pt).sum(dim=(1, 2, 4))
    hot = hot / e.sum(dim=(1, 2, 3))[:, None]
    wp = w[..., : p * pt].reshape(m, kv, g, p, pt)
    out = torch.einsum("mkgt,tkh->mkgh", w[..., p * pt:], vb)
    for c in range(vver.shape[0]):
        wc = torch.where((chain_t == c)[:, None, None, :, None], wp, torch.zeros_like(wp))
        out = out + torch.einsum("mkgpt,ptkh->mkgh", wc, vver[c])
    return out.reshape(m, -1), hot


@torch.no_grad()
def served_logits(w: Dict, conf: Dict, prompt: np.ndarray, served: np.ndarray,
                  widths: np.ndarray, read: np.ndarray, precision: str = "f32") -> torch.Tensor:
    """Logits [n, V] at each served position of one request: the last prompt
    position, then each decoded token's, and each page's share of each
    decode step's attention [n-1, layers, P] (None where ``n`` is 1).
    ``served`` [n] are the tokens the system served; ``widths``/``read``
    [n-1, layers, P] the cache at each decode step (see the module
    docstring)."""
    dev = w["embed"].device
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _forward(w, conf, prompt, served, widths, read, _Linear(precision), dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _forward(w, conf, prompt, served, widths, read, lin, dev):
    d = conf["hidden_size"]
    heads, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // heads
    g = heads // kv
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    pt = conf["tiering"]["page_tokens"]
    s, n = len(prompt), len(served)
    tokens = torch.as_tensor(np.concatenate([prompt, served[:-1]]).astype(np.int64), device=dev)
    t = tokens.numel()
    pos = torch.arange(t, device=dev)
    b, a, f = w["blocks"], w["blocks"]["attn"], w["blocks"]["ffn"]
    x = w["embed"][tokens].to(torch.float32)
    hot = []
    for li in range(conf["num_hidden_layers"]):
        h = rmsnorm(x, b["norm1"][li], eps)
        q = lin(h, a["wq"][li].reshape(d, -1)).reshape(t, heads, hd)
        k = lin(h, a["wk"][li].reshape(d, -1)).reshape(t, kv, hd)
        v = lin(h, a["wv"][li].reshape(d, -1)).reshape(t, kv, hd)
        if conf.get("attention_bias"):
            q = q + a["bq"][li].to(torch.float32)
            k = k + a["bk"][li].to(torch.float32)
            v = v + a["bv"][li].to(torch.float32)
        if conf.get("qk_norm"):
            q = rmsnorm(q, a["q_norm"][li], eps)
            k = rmsnorm(k, a["k_norm"][li], eps)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        qs = (q / hd ** 0.5).reshape(t, kv, g, hd)
        att = torch.empty(t, heads * hd, device=dev)
        att[:s] = _causal(qs[:s], k[:s], v[:s])
        if n > 1:
            kb = k.to(torch.bfloat16).to(torch.float32)
            vb = v.to(torch.bfloat16).to(torch.float32)
            att[s:], h_l = _tiered(qs[s:], kb, vb, widths[:, li], read[:, li], s, pt)
            hot.append(h_l)
        x = x + lin(att, a["wo"][li].reshape(heads * hd, d))
        h = rmsnorm(x, b["norm2"][li], eps)
        x = x + lin(torch.nn.functional.silu(lin(h, f["w_gate"][li])) * lin(h, f["w_up"][li]),
                    f["w_down"][li])
    logits = lin(rmsnorm(x[s - 1:], w["final_norm"], eps), w["lm_head"])
    return logits, (torch.stack(hot, dim=1) if hot else None)
