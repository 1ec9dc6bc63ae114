"""Where one tiered decode step of ``qwen3_moe_235b`` spends its time, on a GPU.

Builds the kernels, then the model at full width and ``chip_smoke.MOE_LAYERS``
layers (random bf16 weights from the smoke's seed) and its engine on the
default path (async + prefetch at the smoke's alpha), serves the smoke's
three requests for ``--steps`` decode steps, and profiles 3 kernel-branch
decode steps on that mid-run state (``chip_smoke.phase_profile``: device
time by kernel and the device's busy share of the host wall time). It also
times one MoE layer at the decode shape with CUDA events, and the expert
products alone (three ``torch.bmm`` over the 128 experts) beside the floor
of their weight bytes at 3.35 TB/s.

    python scripts/moe_step_profile.py [--steps 40]   # from a checkout's root
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import TierScapeRunConfig, get  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_step_profile: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    cfg = dataclasses.replace(get("qwen3_moe_235b"), n_layers=cs.MOE_LAYERS)
    model, params = cs.init_params(cfg)
    ts = TierScapeRunConfig(enabled=True, alpha=cs.ASYNC_ALPHA, window_steps=16,
                            async_migration=True, prefetch=True, faults=False)
    eng = TieredEngine(model, params, batch_slots=2, page_tokens=cs.T, max_seq_len=1024,
                       recent_window=cs.R, ts=ts, device=cs.DEV)
    cs.submit_requests(eng, cfg)
    eng.run(max_steps=args.steps)
    torch.cuda.synchronize()
    # One MoE layer at the decode shape, and its expert products alone.
    blk = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    g = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    x = torch.randn((eng.bs, 1, cfg.d_model), generator=g, device=cs.DEV).to(torch.bfloat16)
    e, c = cfg.moe.n_experts, moe.route(blk, cfg, x)["capacity"]
    xs = torch.randn((e, eng.bs * c, cfg.d_model), generator=g, device=cs.DEV).to(torch.bfloat16)

    def experts():
        h = layers.swiglu(torch.bmm(xs, blk["w_gate"]), torch.bmm(xs, blk["w_up"]))
        return torch.bmm(h, blk["w_down"])

    expert_bytes = sum(blk[w].numel() * blk[w].element_size()
                       for w in ("w_gate", "w_up", "w_down"))
    out = {"layers": cfg.n_layers, "decode_steps_before": eng.stats.steps,
           "moe_layer_decode_ms": cs.time_ms(lambda: moe.moe_ffn(blk, cfg, x)),
           "expert_products_ms": cs.time_ms(experts),
           "expert_bytes_floor_ms": expert_bytes / cs.HBM_BYTES_PER_S * 1e3,
           "launches_before_profile": build.launch_counts()}
    cs.log(json.dumps(out))
    cs.phase_profile(eng, eng.cache.state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
