"""Decode-vs-forward drift of ``mamba2_780m`` at full width and reduced
depth, in both packages on the CPU, with the same weights.

The reference's bar for a decoder's token-by-token decode against its
parallel forward is 0.15 (``tests/test_archs.py``), set on the SMOKE
configs. This script shows how the difference grows with depth at the
published width: the JAX package's model (weights from ``PRNGKey(0)``) and
the port's (the same weights carried across) each run a batch of prompts
through the parallel forward and through one decode step a token, in bf16,
and the port also in f32. One JSON line per depth:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mamba2_drift.py --layers 2 8 24

Needs JAX and PyTorch (CPU). Reduced depth keeps it to a few GB of memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get as jget
from repro.models import Model as JModel
from repro_torch.configs import get
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy


def port_drift(model, params, tokens, dtype) -> tuple:
    full = model.forward(params, {"tokens": tokens})[0]
    state = model.init_cache(tokens.shape[0], tokens.shape[1] + 1, dtype=dtype)
    outs = []
    for i in range(tokens.shape[1]):
        lg, state = model.decode_step(params, tokens[:, i: i + 1], state)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    return full.float(), float((full.float() - dec.float()).abs().max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 8])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=60)
    args = ap.parse_args(argv)
    for n_layers in args.layers:
        t0 = time.perf_counter()
        jcfg = dataclasses.replace(jget("mamba2_780m"), n_layers=n_layers)
        jm = JModel(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tokens = np.random.default_rng(0).integers(1, jcfg.vocab_size, (args.batch, args.seq))
        jt = jnp.asarray(tokens, jnp.int32)
        jfull, _ = jax.jit(jm.forward)(jp, {"tokens": jt})
        step = jax.jit(jm.decode_step)
        state = jm.init_cache(args.batch, args.seq + 1)
        outs = []
        for i in range(args.seq):
            lg, state = step(jp, jt[:, i: i + 1], state)
            outs.append(lg)
        jfull = np.asarray(jfull, np.float32)
        jdrift = float(np.abs(jfull - np.asarray(jnp.concatenate(outs, 1), np.float32)).max())

        model = Model(dataclasses.replace(get("mamba2_780m"), n_layers=n_layers), device="cpu")
        tt = torch.as_tensor(tokens)
        full, drift = port_drift(model, params_from_numpy(jax.tree.map(np.asarray, jp)), tt,
                                 torch.bfloat16)
        p32 = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
        _, drift32 = port_drift(model, p32, tt, torch.float32)
        print(json.dumps({
            "layers": n_layers, "d_model": jcfg.d_model, "batch": args.batch, "seq": args.seq,
            "reference_bf16_decode_vs_forward": jdrift,
            "port_bf16_decode_vs_forward": drift,
            "port_f32_decode_vs_forward": drift32,
            "port_vs_reference_forward_bf16": float(np.abs(full.numpy() - jfull).max()),
            "max_abs_logit": float(np.abs(jfull).max()),
            "cpu_seconds": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
