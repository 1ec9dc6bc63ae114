"""The dense family module pinned to the harness before it had family
modules: the numbers below were computed with the harness's own dense code
before that code moved into ``families/dense.py``, at both configurations'
published shapes and at the small shape of ``test_tierbench_check.py``. The
weights from a seed, the model the engine is built from, the counts behind
``prefill_mfu_pct``, ``decode_mfu_pct``, ``attn_roofline_pct`` and
``quant_roofline_pct``, and the TCO price of a page in each placement level
must stay what they were, bit for bit."""

import copy
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tierbench import counts, families, harness, weights  # noqa: E402

# test_tierbench_check.py's small Qwen shape.
SMALL = {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
         "num_key_value_heads": 2, "num_hidden_layers": 3, "vocab_size": 2048, "head_dim": 64}
SEEDS = (2**31 + 5, 11)
PREFILL_TOKENS = (64, 1020, 1152)
DECODE = ((1, 17, 12345), (2, 3000, 10**7), (6, 40000, 3 * 10**8))  # slots, keys, kv bytes

COUNTS = {
    "qwen1_5_4b": dict(
        weight_bytes=7123240960,
        prefill=((407638507520, 7123568640), (6684823224320, 7128463360),
                 (7580960030720, 7129139200)),
        decode_step=((7121971200, 7123258425), (14274314240, 7133251200),
                     (43140382720, 7423271680)),
        level_costs=("0x1.9000000000000p-10", "0x1.e316000000000p-11", "0x1.c214000000000p-12",
                     "0x1.1306aaaaaaaabp-12", "0x1.2c0d555555556p-13"),
        page_bytes=(84480, 43520), quant_bytes=(1738240, 1451520),
        attention_step_bytes=59008320),
    "qwen3_32b": dict(
        weight_bytes=32762810368,
        prefill=((2000896655360, 32763465728), (32377294028800, 32773255168),
                 (36646820773888, 32774606848)),
        decode_step=((32762003456, 32762832953), (65621196800, 32772830848),
                     (197879398400, 33062871808)),
        level_costs=("0x1.4000000000000p-11", "0x1.8277000000000p-12", "0x1.6828000000000p-13",
                     "0x1.b81aaaaaaaaabp-14", "0x1.e035555555556p-15"),
        page_bytes=(33792, 17408), quant_bytes=(695296, 580608),
        attention_step_bytes=21670144),
    "small": dict(
        weight_bytes=4597760,
        prefill=((233930752, 4630528), (5210392576, 5120000), (6118113280, 5187584)),
        decode_step=((4604928, 4610617), (12247040, 14598784), (68485120, 304600832)),
        level_costs=("0x1.4000000000000p-14", "0x1.8268000000000p-15", "0x1.6940000000000p-16",
                     "0x1.b8d5555555556p-17", "0x1.e1aaaaaaaaaabp-18"),
        page_bytes=(4352, 2304), quant_bytes=(87808, 73472),
        attention_step_bytes=233112),
}
MODEL_CONFIG = {
    "qwen1_5_4b": dict(name="qwen1_5_4b", family="dense", n_layers=40, d_model=2560, n_heads=20,
        n_kv_heads=20, d_ff=6912, vocab_size=151936, head_dim=128, qk_norm=False, qkv_bias=True,
        rope_theta=5000000.0, norm_eps=1e-06, act="swiglu", tie_embeddings=False),
    "qwen3_32b": dict(name="qwen3_32b", family="dense", n_layers=32, d_model=5120, n_heads=64,
        n_kv_heads=8, d_ff=25600, vocab_size=151936, head_dim=128, qk_norm=True, qkv_bias=False,
        rope_theta=1000000.0, norm_eps=1e-06, act="swiglu", tie_embeddings=False),
    "small": dict(name="qwen1_5_4b", family="dense", n_layers=3, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab_size=2048, head_dim=64, qk_norm=False, qkv_bias=True,
        rope_theta=5000000.0, norm_eps=1e-06, act="swiglu", tie_embeddings=False),
    "small_qk": dict(name="qwen3_32b", family="dense", n_layers=3, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab_size=2048, head_dim=64, qk_norm=True, qkv_bias=False,
        rope_theta=1000000.0, norm_eps=1e-06, act="swiglu", tie_embeddings=False),
}
WEIGHTS_SMALL = {
    "embed": ("c0b9af38e3096a16", "4d536b23a2c9e4d4"),
    "lm_head": ("611b1b5e666dea18", "fbc81c5634ffcf9c"),
    "blocks.attn.wq": ("971c602517271a85", "fb0e9dde3c81f092"),
    "blocks.attn.wk": ("d81994632a73fb2c", "9f51ef9b77ad8537"),
    "blocks.attn.wv": ("c23190578164d7d8", "8c5b57d645236d5d"),
    "blocks.attn.wo": ("6c2d78934d7f3864", "15348f0e30d3fc29"),
    "blocks.attn.bq": ("6cb843c6b27b7b8c", "c70f34ba0afb4ee1"),
    "blocks.attn.bk": ("cfd200ea613b3def", "e8b61ea60dc27336"),
    "blocks.attn.bv": ("1b9cd1f951de40d5", "ab6e1d7a2a561668"),
    "blocks.ffn.w_gate": ("4c6033f0e56a01b1", "96cb5e7225bae1c3"),
    "blocks.ffn.w_up": ("9ce298537b27e681", "0542b165b7d0a0ef"),
    "blocks.ffn.w_down": ("c190bfb072dc54a8", "6c554dc6172b9946"),
    "blocks.norm1": ("fb0570b8ba1d9a78", "020586c24c94058e"),
    "blocks.norm2": ("0977af4dddd86fa5", "5ca1678bcaf82739"),
    "final_norm": ("dabb837a909c9697", "81e9e3e4e31d36da"),
}
WEIGHTS_SMALL_QK = {
    "embed": ("c0b9af38e3096a16", "4d536b23a2c9e4d4"),
    "lm_head": ("611b1b5e666dea18", "fbc81c5634ffcf9c"),
    "blocks.attn.wq": ("971c602517271a85", "fb0e9dde3c81f092"),
    "blocks.attn.wk": ("d81994632a73fb2c", "9f51ef9b77ad8537"),
    "blocks.attn.wv": ("c23190578164d7d8", "8c5b57d645236d5d"),
    "blocks.attn.wo": ("6c2d78934d7f3864", "15348f0e30d3fc29"),
    "blocks.attn.q_norm": ("03117e89e156b1ac", "ff22e2754657e59d"),
    "blocks.attn.k_norm": ("37c9ef433d595247", "03ed562a271ecbca"),
    "blocks.ffn.w_gate": ("4c6033f0e56a01b1", "96cb5e7225bae1c3"),
    "blocks.ffn.w_up": ("9ce298537b27e681", "0542b165b7d0a0ef"),
    "blocks.ffn.w_down": ("c190bfb072dc54a8", "6c554dc6172b9946"),
    "blocks.norm1": ("2ab4450b58f6b6e3", "d99e865002699107"),
    "blocks.norm2": ("6b246744d04952e6", "e8174c02ab2ae203"),
    "final_norm": ("6b82cc89fcf6e96f", "a02a2af33f2bb6f9"),
}


def conf(name):
    """A configuration file; ``small`` and ``small_qk`` are qwen1_5_4b's and
    qwen3_32b's at the small shape."""
    base = {"small": "qwen1_5_4b", "small_qk": "qwen3_32b"}.get(name, name)
    c = copy.deepcopy(harness.load_json(harness.HERE / "configs" / f"{base}.json"))
    if base != name:
        c.update(SMALL)
    return c


@pytest.mark.parametrize("name", list(COUNTS))
def test_dense_counts_are_the_parents(name):
    c, want = conf(name), COUNTS[name]
    fam = families.of(c)
    assert fam.__name__ == "tierbench.families.dense"
    assert fam.weight_bytes(c) == want["weight_bytes"]
    assert tuple(fam.prefill(c, s) for s in PREFILL_TOKENS) == want["prefill"]
    assert tuple(fam.decode_step(c, *a) for a in DECODE) == want["decode_step"]
    assert tuple(float(x).hex() for x in harness.page_costs(c)) == want["level_costs"]
    m = fam.shape(c)
    pt = c["tiering"]["page_tokens"]
    assert tuple(counts.page_bytes(m, pt, b) for b in (8, 4)) == want["page_bytes"]
    assert tuple(counts.quant_bytes(m, pt, 7, b) for b in (8, 4)) == want["quant_bytes"]
    full = np.full((m.layers, 2), 1)
    assert counts.attention_step_bytes(m, pt, 8, 4, 5 * full, 3 * full, 2 * full,
                                       np.array([20, 9])) == want["attention_step_bytes"]


@pytest.mark.parametrize("name", list(MODEL_CONFIG))
def test_dense_model_config_is_the_parents(name):
    from repro_torch.configs.base import ModelConfig

    assert families.of(conf(name)).model_config(conf(name)) == ModelConfig(**MODEL_CONFIG[name])


def _digest(t):
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name,want", [("small", WEIGHTS_SMALL), ("small_qk", WEIGHTS_SMALL_QK)])
@pytest.mark.parametrize("at", range(len(SEEDS)))
def test_dense_weights_are_the_parents(name, want, at):
    tree, got = weights.make(conf(name), SEEDS[at], "cpu"), {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                got[".".join(path + (k,))] = _digest(v)[:16]

    walk(tree, ())
    assert got == {path: pair[at] for path, pair in want.items()}
