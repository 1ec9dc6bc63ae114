"""A model family of another kind is files only: a family module and a plain
reference, found by name, and the harness runs a cell of it with no edit.

The test registers a mixture-of-experts family module and a reference
under ``tierbench.families`` and ``tierbench.references`` (in
``sys.modules``, as an added file would be found), at the port's ``moe``
SMOKE sizes: d 64, 4 heads of 32, 2 KV heads, 8 experts top-2 of width 96,
2 layers, vocab 256. ``harness.run_cell`` then builds the engine from the
module's ``ModelConfig``, draws the module's weights (an f32 router among
them), warms up, serves the window on a virtual clock, runs the traced slice
and the check, and every per-layer reader of ``BENCHMARK.json`` reads the
result. The reference's numbers are not held here: it answers with zero
logits, so that the run's check has something to compare."""

import copy
import importlib
import math
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from tierbench import counts, families, harness, weights  # noqa: E402
from tierbench.test_tierbench_check import MIX, VClock  # noqa: E402

NAME = "fixture_moe"
CONF = {"name": NAME, "family": NAME, "reference": NAME,
        "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
        "num_hidden_layers": 2, "vocab_size": 256, "num_experts": 8, "num_experts_per_tok": 2,
        "moe_intermediate_size": 96, "qk_norm": True, "rms_norm_eps": 1e-6,
        "rope_theta": 1000000.0}


def _dims(conf):
    return (conf["num_hidden_layers"], conf["hidden_size"], conf["num_attention_heads"],
            conf["num_key_value_heads"], conf["head_dim"], conf["num_experts"],
            conf["num_experts_per_tok"], conf["moe_intermediate_size"], conf["vocab_size"])


def model_config(conf):
    from repro_torch.configs.base import ModelConfig, MoEConfig

    L, d, H, KV, hd, E, k, f, V = _dims(conf)
    return ModelConfig(name=conf["name"], family="moe", n_layers=L, d_model=d, n_heads=H,
                       n_kv_heads=KV, d_ff=f, vocab_size=V, head_dim=hd, qk_norm=True,
                       rope_theta=float(conf["rope_theta"]), norm_eps=float(conf["rms_norm_eps"]),
                       moe=MoEConfig(n_experts=E, experts_per_token=k, d_ff_expert=f))


def weight_layout(conf):
    L, d, H, KV, hd, E, k, f, V = _dims(conf)
    bf16, f32, norm = torch.bfloat16, torch.float32, families.NORM
    return [(("embed",), (V, d), bf16, 0.02), (("lm_head",), (d, V), bf16, d ** -0.5),
            (("blocks", "attn", "wq"), (L, d, H, hd), bf16, d ** -0.5),
            (("blocks", "attn", "wk"), (L, d, KV, hd), bf16, d ** -0.5),
            (("blocks", "attn", "wv"), (L, d, KV, hd), bf16, d ** -0.5),
            (("blocks", "attn", "wo"), (L, H, hd, d), bf16, (H * hd) ** -0.5),
            (("blocks", "moe", "w_gate"), (L, E, d, f), bf16, d ** -0.5),
            (("blocks", "moe", "w_up"), (L, E, d, f), bf16, d ** -0.5),
            (("blocks", "moe", "w_down"), (L, E, f, d), bf16, f ** -0.5),
            (("blocks", "moe", "router"), (L, d, E), f32, d ** -0.5),
            (("final_norm",), (d,), f32, norm), (("blocks", "norm1"), (L, d), f32, norm),
            (("blocks", "norm2"), (L, d), f32, norm),
            (("blocks", "attn", "q_norm"), (L, hd), f32, norm),
            (("blocks", "attn", "k_norm"), (L, hd), f32, norm)]


def shape(conf):
    L, d, H, KV, hd, E, k, f, V = _dims(conf)
    return families.Shape(layers=L, heads=H, kv=KV, hd=hd)


def weight_bytes(conf):
    """Every weight but the embedding, whose rows count per token: the
    port's MoE reads every expert."""
    return sum(math.prod(s) * (counts.F32 if t == torch.float32 else counts.BF16)
               for path, s, t, _ in weight_layout(conf) if path != ("embed",))


def _token_flops(conf):
    L, d, H, KV, hd, E, k, f, V = _dims(conf)
    return 2 * L * (d * (H + 2 * KV) * hd + H * hd * d + d * E + k * 3 * d * f)


def prefill(conf, s):
    L, d, H = conf["num_hidden_layers"], conf["hidden_size"], conf["num_attention_heads"]
    flops = s * _token_flops(conf) + L * 4 * H * conf["head_dim"] * s * (s + 1) // 2
    return flops + 2 * d * conf["vocab_size"], weight_bytes(conf) + s * d * counts.BF16


def decode_step(conf, slots, keys, kv_bytes):
    d, V = conf["hidden_size"], conf["vocab_size"]
    flops = slots * (_token_flops(conf) + 2 * d * V)
    flops += 4 * conf["num_attention_heads"] * conf["head_dim"] * keys
    return flops, weight_bytes(conf) + slots * d * counts.BF16 + kv_bytes


def served_logits(params, conf, prompt, served, widths, read, precision="f32"):
    return torch.zeros(len(served), conf["vocab_size"]), None


@pytest.fixture
def registered(monkeypatch):
    family = types.ModuleType(f"tierbench.families.{NAME}")
    for fn in (model_config, weight_layout, shape, weight_bytes, prefill, decode_step):
        setattr(family, fn.__name__, fn)
    reference = types.ModuleType(f"tierbench.references.{NAME}")
    reference.served_logits = served_logits
    monkeypatch.setitem(sys.modules, family.__name__, family)
    monkeypatch.setitem(sys.modules, reference.__name__, reference)


def test_a_family_of_files_runs_through_the_harness(registered):
    cell = harness.load_cell("qwen3_32b-longctx")
    cell.name = f"{NAME}-small"
    cell.conf = dict(copy.deepcopy(CONF), tiering=copy.deepcopy(cell.conf["tiering"]))
    cell.mix = MIX
    cell.cell = {"batch_slots": 2, "max_seq_len": 144, "rate_rps": 6.0, "warm_s": 0.5,
                 "sample_tokens": 40, "trace_steps": 6, "limits": {"logit_gap": 1.0}}
    assert families.of(cell.conf) is sys.modules[f"tierbench.families.{NAME}"]
    params = weights.make(cell.conf, 3, "cpu")
    assert params["blocks"]["moe"]["router"].dtype == torch.float32
    assert params["blocks"]["moe"]["w_gate"].shape == (2, 8, 64, 96)

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        vc = VClock()
        res = harness.run_cell(cell, 3, 1.0, True, "cpu", 0.0, clock=vc.now, sleep=vc.sleep)
    finally:
        torch.set_num_threads(n_threads)
    assert res.drv.shape[0] == 2 and res.e2e["_tokens_in_window"] > 0
    assert res.window_steps[1] > res.window_steps[0] and res.slice_steps[1] > res.slice_steps[0]
    assert res.e2e["_boundaries"] > 0 and 0 < res.e2e["tco_savings_pct"] < 100
    assert res.correct and res.gaps, res.checks
    got = {}
    for spec in cell.manifest["per_layer"]:
        got[spec["name"]] = importlib.import_module(f"tierbench.metrics.{spec['name']}").read(res)
    for name, v in got.items():
        assert v is None or (isinstance(v, float) and math.isfinite(v)), (name, v)
    # The readers that count the model's work read it through the module.
    assert got["prefill_mfu_pct"] > 0 and got["decode_mfu_pct"] > 0
    listed = harness.per_layer(res)
    assert set(listed) <= {n for n, v in got.items() if v is not None}
