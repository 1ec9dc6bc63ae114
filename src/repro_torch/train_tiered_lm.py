"""End-to-end training program of the port, after
``examples/train_tiered_lm.py``: a small dense LM trained for a few hundred
steps with the full stack —

  * synthetic packed corpus via the sharded HostLoader (prefetch +
    straggler mitigation),
  * TierScape tiered optimizer state: embedding/lm_head Adam moments live
    in an int8 compressed tier (µ-law dynamic code),
  * cosine schedule + global-norm clipping,
  * atomic async checkpointing with resume,
  * (optional) int8 error-feedback gradient compression, the cross-pod
    wire format.

The flags and defaults are the reference's; ``--device`` (default
``cuda``) picks the card or, with ``cpu``, the CPU.

    PYTHONPATH=src python -m repro_torch.train_tiered_lm --steps 200
    PYTHONPATH=src python -m repro_torch.train_tiered_lm --device cpu \\
        --steps 40 --d-model 64 --layers 2 --seq 64 --batch 4 --vocab 512
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, HostLoader
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.optim import adamw, grad_compress, tiered_adam
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train import value_and_grad


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 error-feedback roundtrip on gradients")
    ap.add_argument("--moment-codec", default="int8",
                    choices=["none", "bf16", "int8", "int4"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = ModelConfig(
        name="tiered_lm", family="dense",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=max(args.d_model // 64, 2),
        n_kv_heads=max(args.d_model // 128, 1),
        d_ff=args.d_model * 4, vocab_size=args.vocab, act="swiglu",
    )
    model = Model(cfg, device=dev)
    params = model.init(0)
    n_params = sum(x.numel() for x in pytree.leaves(params))
    print(f"model: {n_params/1e6:.1f}M params "
          f"({cfg.n_layers}L x {cfg.d_model}d, vocab {cfg.vocab_size}) on {dev}")

    policy = tiered_adam.default_policy(params, cold_codec=args.moment_codec)
    opt_state = tiered_adam.init(params, policy)
    f32_bytes = n_params * 8  # m+v f32
    print(f"optimizer moments: {tiered_adam.moment_bytes(opt_state)/1e6:.1f}MB "
          f"(f32 baseline {f32_bytes/1e6:.1f}MB) — embeddings in the "
          f"{args.moment_codec} tier")

    opt_cfg = AdamWConfig(lr=args.lr, schedule=adamw.cosine_schedule(20, args.steps))
    residual = grad_compress.init_residual(params) if args.grad_compress else None

    def train_step(params, opt_state, resid, batch):
        loss, _, grads = value_and_grad(model, params, batch)
        if resid is not None:
            out = [grad_compress.compress_roundtrip(g.to(torch.float32) + r)
                   for g, r in zip(pytree.leaves(grads), pytree.leaves(resid))]
            grads = pytree.unflatten(grads, [o[0] for o in out])
            resid = pytree.unflatten(grads, [o[1] for o in out])
        params, opt_state, om = tiered_adam.update(grads, opt_state, params, opt_cfg)
        return params, opt_state, resid, loss, om["grad_norm"]

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start, restored = ckpt.restore({"params": params})
        params = restored["params"]
        print(f"resumed from step {start}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    loader = HostLoader(data_cfg, start_step=start)

    losses = []
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in next(loader).items()}
            params, opt_state, residual, loss, gnorm = train_step(
                params, opt_state, residual, batch)
            losses.append(float(loss))
            if (step + 1) % 20 == 0:
                rate = (step + 1 - start) / (time.time() - t0)
                print(f"step {step+1:4d} loss {np.mean(losses[-20:]):.4f} "
                      f"gnorm {float(gnorm):.2f} ({rate:.2f} steps/s, "
                      f"stragglers {loader.straggler_events})")
            if (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params}, blocking=False)
        ckpt.wait()
    finally:
        loader.close()
    print(f"final loss {np.mean(losses[-20:]):.4f} "
          f"(from {np.mean(losses[:20]):.4f}); checkpoints in {args.ckpt_dir}")
    assert np.mean(losses[-20:]) < np.mean(losses[:20]), "training must descend"


if __name__ == "__main__":
    main()
