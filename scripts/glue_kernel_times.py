"""Times of the decode step's glue kernels (``kernels/decode_glue.py``) on a
GPU, at the benchmark cells' shapes, beside their byte bounds and their plain
versions.

    python scripts/glue_kernel_times.py

From the root of a checkout, on a CUDA card. For ``qwen1_5_4b`` (B = 2; 20
MHA heads with QKV biases, d 2560, ffn 6912) and ``qwen3_32b`` (B = 6; 64/8
GQA heads with qk-norm, d 5120, ffn 25600), each of ``rmsnorm``,
``qkv_epilogue`` and ``silu_mul`` is captured ``REPS`` times back to back
in one CUDA graph, and the median over ``ROUNDS`` replays is its device time
a call (inputs warm in L2, as the step finds them right after the GEMM that
wrote them); the plain version the same way, and for ``rmsnorm`` also
``torch.nn.functional.rms_norm`` as a yardstick. The bound is the bytes the
call must move (each input read once, each output written once) over 3.35
TB/s. Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REPS, ROUNDS, HBM = 200, 15, 3.35e12
CELLS = (("qwen1_5_4b", 2), ("qwen3_32b", 6))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip()


def time_ms(fn) -> float:
    """Device ms a call: ``REPS`` calls captured as one CUDA graph (as the
    decode step replays them, with no host launch cost), the median of
    ``ROUNDS`` replays between two events, over ``REPS``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(ROUNDS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / REPS)
    return statistics.median(runs)


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.kernels import decode_glue as dg
    from repro_torch.models import layers

    if not torch.cuda.is_available():
        print("glue_kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)
    line = {"card": card()}
    for arch, b in CELLS:
        cfg = get(arch)
        d, h, kv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_(), cfg.d_ff
        r, bf = 32, torch.bfloat16

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(bf)

        x, w = rnd(b, 1, d), 1 + 0.1 * torch.randn(d, generator=g, device="cuda")
        w_bf = w.to(bf)
        q, k, v = rnd(b, 1, h, hd), rnd(b, 1, kv, hd), rnd(b, 1, kv, hd)
        bias = (rnd(h, hd), rnd(kv, hd), rnd(kv, hd)) if cfg.qkv_bias else None
        norms = ((1 + 0.1 * torch.randn(hd, generator=g, device="cuda"),) * 2
                 if cfg.qk_norm else None)
        pos = torch.tensor([[1000 + 7 * i] for i in range(b)], dtype=torch.int32, device="cuda")
        cos, sin = layers.rope_cos_sin(pos, hd, cfg.rope_theta, "cuda")
        rk, rv = rnd(b, r, kv, hd), rnd(b, r, kv, hd)
        rl = torch.full((b,), 5, dtype=torch.int32, device="cuda")
        gate, up = rnd(b, 1, ff), rnd(b, 1, ff)
        epi = (q, k, v, cos, sin, rk, rv, rl)
        epi_kw = dict(bias=bias, qk_norm=norms, eps=cfg.norm_eps)
        rows = b * (h + 2 * kv) * hd
        epi_bytes = (2 * rows + 2 * (h + 2 * kv) * hd * (bias is not None) + 8 * hd * (norms
                     is not None) + 4 * b * hd + 4 * b + 2 * b * (h + 2 * kv) * hd)
        line[arch] = {
            "batch": b,
            "rmsnorm": {"ms": time_ms(lambda: dg.rmsnorm(w, x, cfg.norm_eps)),
                        "bound_ms": (4 * b * d + 4 * d) / HBM * 1e3,
                        "plain_ms": time_ms(lambda: dg.rmsnorm_plain(w, x, cfg.norm_eps)),
                        "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w_bf, cfg.norm_eps))},
            "qkv_epilogue": {"ms": time_ms(lambda: dg.qkv_epilogue(*epi, **epi_kw)),
                             "bound_ms": epi_bytes / HBM * 1e3,
                             "plain_ms": time_ms(lambda: dg.qkv_epilogue_plain(*epi, **epi_kw))},
            "silu_mul": {"ms": time_ms(lambda: dg.silu_mul(gate, up)),
                         "bound_ms": 6 * b * ff / HBM * 1e3,
                         "plain_ms": time_ms(lambda: dg.silu_mul_plain(gate, up))},
        }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
