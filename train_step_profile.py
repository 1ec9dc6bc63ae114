"""Where one full-width ``qwen1_5_4b`` train step spends its time, on a GPU.

Builds the model of ``chip_smoke.py`` phase 2j (full width and depth, random
bf16 weights from the smoke's seed, tiered Adam under ``default_policy``,
remat on, the smoke's optimizer) and runs its steps on one 2 x 512-token
batch from ``HostLoader``: ``--warmup`` steps, then ``--steps`` timed on the
host clock after a sync, split into the forward + backward
(``runtime.train.value_and_grad``) and the optimizer update
(``tiered_adam.update``), then one step under ``torch.profiler``: device
time by kernel, GEMM kernels against the rest, and the device's busy share
of the host wall time. Each part is set beside its bound on the H100's
published peaks: the weight products' bf16 operations (forward, remat's
second forward and the backward's two products per forward product) at
989 TFLOP/s plus the attention products' f32 operations at 67 TFLOP/s, and
the update's bytes (each parameter, gradient and moment read once and each
parameter and moment written once) at 3.35 TB/s.

    python3 train_step_profile.py [--steps 3]   # from the root of a checkout
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.data.pipeline import synthetic_corpus  # noqa: E402
from repro_torch.optim import tiered_adam  # noqa: E402
from repro_torch.runtime.train import value_and_grad  # noqa: E402

BF16_OPS_PER_S = 989e12  # H100 SXM, dense, at 700 W (NVIDIA's data sheet)
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")  # GEMM kernels, by name
MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def step_ops(cfg, tokens: int, params) -> tuple:
    """(bf16 weight-product operations, f32 attention operations) of one
    step: 2 per weight per token forward, again for remat's second forward
    (the blocks only), and 4 backward; the attention products (QK^T and PV
    over the full S x S, as the port computes them, in f32) likewise."""
    body = sum(p.numel() for k, p in pytree.leaves_with_path(params)
               if k.startswith("blocks/") and k.split("/")[-1] in MATRICES)
    head = params["lm_head"].numel()
    attn = 4 * tokens * cs.TRAIN_SEQ * cfg.n_heads * cfg.head_dim_() * cfg.n_layers
    return 8 * tokens * body + 6 * tokens * head, 4 * attn


def update_bytes(params, grads, opt) -> int:
    """Bytes the update must move: params, grads and moments read once,
    params and moments written once."""
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in pytree.leaves(tree))

    moments = tiered_adam.moment_bytes(opt)
    return 2 * nbytes(params) + nbytes(grads) + 2 * moments


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA GPU", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("qwen1_5_4b")
    model, params, policy, opt, dcfg, step = cs._train_setup(cfg)
    opt_cfg = cs.train_optimizer()
    batch = cs._device_batch(synthetic_corpus(dcfg, 0))
    tokens = cs.TRAIN_BATCH * cs.TRAIN_SEQ
    for _ in range(args.warmup):
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()

    fb_ms, up_ms = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        _, _, grads = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, _ = tiered_adam.update(grads, opt, params, opt_cfg)
        torch.cuda.synchronize()
        fb_ms.append((t1 - t0) * 1e3)
        up_ms.append((time.perf_counter() - t1) * 1e3)
    moved = update_bytes(params, grads, opt)
    del grads

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms <= 0:
        cs.fail("the profiler recorded no device time")
    gemm_ms = sum(e.self_device_time_total for e in events
                  if any(n in e.key.lower() for n in GEMM_NAMES)) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    bf16_ops, f32_ops = step_ops(cfg, tokens, params)
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "tokens_per_step": tokens,
        "fwd_bwd_ms": fb_ms, "update_ms": up_ms,
        "fwd_bwd_bound_ms": (bf16_ops / BF16_OPS_PER_S + f32_ops / cs.F32_OPS_PER_S) * 1e3,
        "bf16_ops": bf16_ops, "f32_attention_ops": f32_ops,
        "update_bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3, "update_bytes": moved,
        "profiled_step_wall_ms": wall_ms, "profiled_step_device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms, "gemm_device_ms": gemm_ms,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
        "kernel_launches": cs.build.launch_counts(),
    }
    cs.log(json.dumps(out))
    cs.log(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
