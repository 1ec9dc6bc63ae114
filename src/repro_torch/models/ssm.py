"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block, after
``repro.models.ssm``.

Prefill path: the chunked SSD algorithm (block-diagonal intra-chunk
"attention" + an inter-chunk recurrence over chunk states). Decode path: the
recurrent update with an O(1) state ``[B, H, P, N]`` plus a depthwise-conv
ring buffer. Both are plain tensor operations and matrix products (the
reference's are plain jnp too: no kernel of its own).

Shapes follow the paper's minimal SSD listing:
  x:  [B, L, H, P]   (H heads, P head_dim)
  dt: [B, L, H]      (softplus-activated step sizes)
  A:  [H]            (negative scalars)
  B,C:[B, L, G, N]   (G state groups, N d_state)

Rounding points are the reference's: the projections, conv and gated norm
run in the parameters' dtype (bf16 in serving), softplus / exp / silu and the
whole SSD scan in f32, the SSM state in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def init_ssm_params(gen: torch.Generator, cfg: ModelConfig, lead=(), dtype=torch.bfloat16,
                    device="cpu") -> dict:
    """Mixer weights with leading dims ``lead`` (the layer stack)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    g, n = s.n_groups, s.d_state
    lead = tuple(lead)
    ax = len(lead)
    # in_proj emits [z (gate), x, B, C, dt] concatenated.
    d_in_proj = 2 * di + 2 * g * n + nh
    c_conv = di + 2 * g * n

    def init(shape):
        return layers.dense_init(gen, lead + shape, in_axis=ax, dtype=dtype, device=device)

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        "in_proj": init((d, d_in_proj)),
        "conv_w": init((s.conv_kernel, c_conv)),
        "conv_b": full((c_conv,), 0.0, dtype),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "A_log": full((nh,), 0.0, torch.float32),  # A = -exp(A_log)
        "D": full((nh,), 1.0, torch.float32),
        "norm_w": full((di,), 1.0, torch.float32),  # gated RMSNorm pre out_proj
        "out_proj": init((di, d)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    g, n = s.n_groups, s.d_state
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * g * n, zxbcdt.shape[-1] - 2 * di - 2 * g * n],
                             dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, L, C] with kernel [K, C]."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1]] * w[i] for i in range(k))
    return F.silu((out + b).to(torch.float32)).to(xbc.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum' producing the 1-semiseparable mask (SSD paper).

    x: [..., L] -> [..., L, L] with out[i,j] = sum_{j<k<=i} x[k], -inf for
    j>i (so exp gives the causal decay with exact zeros above the diagonal)."""
    n = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    diff = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in f32. Returns (y [B,L,H,P], final_state [B,H,P,N]).

    a: [H] negative; b/c: [B, L, G, N] broadcast over heads per group."""
    bsz, n_tok, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    orig_l = n_tok
    pad = (-n_tok) % chunk
    if pad:
        # Zero-pad the tail: dt=0 makes padded steps identity state updates
        # (exp(0)=1 decay, zero input contribution), so the final state and
        # the first orig_l outputs are exact.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        n_tok += pad
    nc = n_tok // chunk
    rep = h // g
    f32 = torch.float32

    # Reshape into chunks (u = chunk index, i/j = position in the chunk,
    # h = head, p = head_dim, s = state dim).
    xc = x.reshape(bsz, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bh = torch.repeat_interleave(b.reshape(bsz, nc, chunk, g, n), rep, dim=3).to(f32)
    ch_ = torch.repeat_interleave(c.reshape(bsz, nc, chunk, g, n), rep, dim=3).to(f32)

    da = dtc * a  # [B,u,ch,H] (log decay per step)
    da_cs = torch.cumsum(da, dim=2)  # within-chunk cumulative

    # 1. Intra-chunk (diagonal block) output.
    att = torch.exp(_segsum(da.transpose(2, 3)))  # [B,u,H,ch,ch]
    scores = torch.einsum("buihs,bujhs->buhij", ch_, bh) * att
    y_diag = torch.einsum("buhij,bujhp->buihp", scores, dtc[..., None] * xc)

    # 2. Chunk-final states: decay-weighted sum of inputs.
    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # [B,u,ch,H]
    states = torch.einsum("bujhs,bujhp->buhps", bh, (dtc * decay_to_end)[..., None] * xc)

    # 3. Inter-chunk recurrence over chunk states (the reference's
    # associative scan, written as the sequential scan it computes).
    chunk_decay = torch.exp(da_cs[:, :, -1, :])  # [B,u,H]
    scanned = [states[:, 0]]
    for u in range(1, nc):
        scanned.append(scanned[-1] * chunk_decay[:, u, :, None, None] + states[:, u])
    # States *entering* each chunk = scan result shifted by one.
    entering = torch.stack([torch.zeros_like(scanned[0])] + scanned[:-1], dim=1)  # [B,u,H,P,N]

    # 4. Inter-chunk contribution to outputs.
    decay_from_start = torch.exp(da_cs)  # [B,u,ch,H]
    y_off = torch.einsum("buihs,buhps->buihp", ch_, entering) * decay_from_start[..., None]

    y = (y_diag + y_off).reshape(bsz, n_tok, h, p)[:, :orig_l]
    return y, scanned[-1]


def ssm_block(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm -> out_proj."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    g, n = s.n_groups, s.d_state

    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)
    bsz, n_tok, _ = xs.shape
    xs = xs.reshape(bsz, n_tok, nh, s.head_dim)
    b = b.reshape(bsz, n_tok, g, n)
    c = c.reshape(bsz, n_tok, g, n)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])

    y, _ = ssd_chunked(xs, dt, a, b, c, min(s.chunk, n_tok))
    y = y + xs.to(torch.float32) * p["D"][:, None]
    y = y.reshape(bsz, n_tok, di).to(x.dtype)

    # Gated RMSNorm (mamba2 uses norm(y * silu(z))).
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    y = layers.rmsnorm(p["norm_w"], y, cfg.norm_eps)
    return torch.matmul(y, p["out_proj"])


def ssm_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step.

    x: [B, 1, D]; conv_state: [B, K-1, C_conv]; ssm_state: [B, H, P, N] f32.
    Returns (y [B,1,D], new_conv_state, new_ssm_state) as new tensors."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    g, n = s.n_groups, s.d_state

    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = xbc[:, 0]  # [B, C_conv]

    # Conv ring buffer: full window = [conv_state, xbc].
    window = torch.cat([conv_state, xbc[:, None]], dim=1)  # [B,K,C]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out.to(torch.float32)).to(x.dtype)
    new_conv_state = window[:, 1:]

    xs, b, c = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    bsz = xs.shape[0]
    xs = xs.reshape(bsz, nh, s.head_dim).to(torch.float32)
    rep = nh // g
    bh = torch.repeat_interleave(b.reshape(bsz, g, n), rep, dim=1).to(torch.float32)  # [B,H,N]
    ch_ = torch.repeat_interleave(c.reshape(bsz, g, n), rep, dim=1).to(torch.float32)

    dt1 = _softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])  # [B,H]
    a = -torch.exp(p["A_log"])  # [H]
    da = torch.exp(dt1 * a)  # [B,H]

    new_state = (ssm_state * da[..., None, None]
                 + (dt1[..., None] * xs)[..., None] * bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch_)
    y = y + xs * p["D"][:, None]
    y = y.reshape(bsz, di)

    y = y * F.silu(z[:, 0].to(torch.float32))
    y = layers.rmsnorm(p["norm_w"], y.to(x.dtype), cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"])
    return out[:, None], new_conv_state, new_state
