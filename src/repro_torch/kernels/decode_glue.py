"""The tiered decode step's per-layer glue: wrappers of the CUDA kernels
``csrc/decode_glue.cu`` (RMSNorm, the QKV epilogue, SiLU(gate) * up), and
their plain versions.

Replaces no Pallas kernel: the JAX package leaves these ops to XLA, which
fuses them inside its jitted step. In eager PyTorch each is a chain of small
kernels (a norm is seven; biases, qk-norm and RoPE on q and k some forty; the
recent-window write six), which the captured step replays one after another
at the launch floor. Each kernel does its chain in one launch, reading its
inputs once and writing its outputs once, so its time is the launch's.

The plain versions are the ops the step ran before (``models.layers``), and
the kernels follow them op for op in f32; only the order of a norm's sum of
squares differs (within one ulp of the activation type). Each wrapper runs
its plain version off the card (``build.on_card``: CPU and ``meta`` tensors),
and on CUDA tensors checks the operands and launches its kernel (or raises).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.models import layers

_P = ctypes.c_void_p
ACT_DTYPES = (torch.bfloat16, torch.float32)


def _act_dtype(kernel: str, x: torch.Tensor):
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"{kernel}: activations must be one of {ACT_DTYPES}, got {x.dtype}")
    return x.dtype


# ------------------------------------------------------------------ rmsnorm
def rmsnorm_plain(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return layers.rmsnorm(w, x, eps)


def rmsnorm_max_d(dtype) -> int:
    """The widest row the kernel takes: 512 threads of 4 vectors of 16
    bytes (``csrc/decode_glue.cu``'s ``kNormThreads`` x ``kNormVecs``)."""
    return 512 * 4 * (16 // dtype.itemsize)


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """``layers.rmsnorm``: x [..., D] (bf16 or f32), w [D] f32 -> x's type;
    one launch, one block a row, which each thread reads as 16-byte vectors
    (D a multiple of 16 bytes, at most ``rmsnorm_max_d``)."""
    if not build.on_card(x):
        return rmsnorm_plain(w, x, eps)
    name = "rmsnorm"
    dev, d = x.device, x.shape[-1]
    dt = _act_dtype(name, x)
    vec = 16 // x.element_size()
    if d % vec or d > rmsnorm_max_d(dt):
        raise ValueError(f"{name}: the row ({d}) must be a multiple of {vec} and at most "
                         f"{rmsnorm_max_d(dt)} for {dt}")
    build.check_operand(name, "x", x, dt, dev)
    build.check_operand(name, "w", w, torch.float32, dev, (d,))
    out = torch.empty_like(x)
    for nm, t in (("x", x), ("w", w), ("out", out)):
        build.check_aligned(name, nm, t, 16)
    fn = build.load("decode_glue").rmsnorm_launch
    fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // d, d, float(eps),
             int(dt == torch.bfloat16), build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return out


# ------------------------------------------------------------- QKV epilogue
def qkv_epilogue_plain(q, k, v, cos, sin, recent_k, recent_v, recent_len,
                       bias: Optional[Sequence[torch.Tensor]] = None,
                       qk_norm: Optional[Sequence[torch.Tensor]] = None, eps: float = 1e-5):
    """What follows the QKV products in ``models.attention._project_qkv``
    (biases, then qk-norm, then RoPE by ``layers.rope_cos_sin``'s cos and
    sin), and the tiered step's write of the new k and v into row
    ``recent_len[b]`` of each slot's window (nothing where that row is outside
    the window). q [B, 1, H, hd], k, v [B, 1, KV, hd]; ``recent_k``/``recent_v``
    [B, R, KV, hd] are written in place. Returns q."""
    if bias is not None:
        q, k, v = q + bias[0], k + bias[1], v + bias[2]
    if qk_norm is not None:
        q = layers.rmsnorm(qk_norm[0], q, eps)
        k = layers.rmsnorm(qk_norm[1], k, eps)
    q, k = layers.rotate(q, cos, sin), layers.rotate(k, cos, sin)
    r = recent_k.shape[1]
    at = torch.arange(r, dtype=torch.int32, device=q.device)[None, :] == recent_len[:, None]
    at = at[:, :, None, None]  # [B, R, 1, 1]
    recent_k.copy_(torch.where(at, k.to(recent_k.dtype), recent_k))
    recent_v.copy_(torch.where(at, v.to(recent_v.dtype), recent_v))
    return q


def qkv_epilogue(q, k, v, cos, sin, recent_k, recent_v, recent_len,
                 bias: Optional[Sequence[torch.Tensor]] = None,
                 qk_norm: Optional[Sequence[torch.Tensor]] = None, eps: float = 1e-5):
    """``qkv_epilogue_plain`` in one launch: one warp a head row (H query,
    KV key and KV value heads a slot). ``bias`` is (bq [H, hd], bk, bv
    [KV, hd]) in q's type, ``qk_norm`` (q_norm, k_norm [hd]) f32, cos/sin
    [B, 1, 1, hd/2] f32, ``recent_len`` [B] int32, the windows bf16."""
    if not build.on_card(q):
        return qkv_epilogue_plain(q, k, v, cos, sin, recent_k, recent_v, recent_len, bias,
                                  qk_norm, eps)
    name = "qkv_epilogue"
    dev = q.device
    b, s, h, hd = q.shape
    kv, r = k.shape[2], recent_k.shape[1]
    if s != 1 or hd % 2 or hd > 256:
        raise ValueError(f"{name}: one token a slot and an even head_dim <= 256, got "
                         f"q of shape {tuple(q.shape)}")
    dt = _act_dtype(name, q)
    f32 = torch.float32
    operands = [("q", q, dt, (b, 1, h, hd)), ("k", k, dt, (b, 1, kv, hd)),
                ("v", v, dt, (b, 1, kv, hd)), ("cos", cos, f32, (b, 1, 1, hd // 2)),
                ("sin", sin, f32, (b, 1, 1, hd // 2)),
                ("recent_k", recent_k, torch.bfloat16, (b, r, kv, hd)),
                ("recent_v", recent_v, torch.bfloat16, (b, r, kv, hd)),
                ("recent_len", recent_len, torch.int32, (b,))]
    if bias is not None:
        operands += [("bq", bias[0], dt, (h, hd)), ("bk", bias[1], dt, (kv, hd)),
                     ("bv", bias[2], dt, (kv, hd))]
    if qk_norm is not None:
        operands += [("q_norm", qk_norm[0], f32, (hd,)), ("k_norm", qk_norm[1], f32, (hd,))]
    for nm, x, want, shape in operands:
        build.check_operand(name, nm, x, want, dev, shape)
    out = torch.empty_like(q)
    none = (None, None, None)
    bq, bk, bv = (t.data_ptr() for t in bias) if bias is not None else none
    qn, kn = (t.data_ptr() for t in qk_norm) if qk_norm is not None else none[:2]
    fn = build.load("decode_glue").qkv_epilogue_launch
    fn.argtypes = [_P] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bq, bk, bv, qn, kn, cos.data_ptr(),
             sin.data_ptr(), recent_len.data_ptr(), out.data_ptr(), recent_k.data_ptr(),
             recent_v.data_ptr(), b, h, kv, hd, r, float(eps), int(dt == torch.bfloat16),
             build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return out


# ----------------------------------------------------------------- SiLU * up
def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return layers.swiglu(gate, up)


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``layers.swiglu``: round(SiLU(gate) in f32) * up, in one launch."""
    if not build.on_card(gate):
        return silu_mul_plain(gate, up)
    name = "silu_mul"
    dev = gate.device
    dt = _act_dtype(name, gate)
    build.check_operand(name, "gate", gate, dt, dev)
    build.check_operand(name, "up", up, dt, dev, gate.shape)
    out = torch.empty_like(gate)
    fn = build.load("decode_glue").silu_mul_launch
    fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(),
             int(dt == torch.bfloat16), build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return out
