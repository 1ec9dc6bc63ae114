"""The encoder family (``hubert_xlarge``: bidirectional attention, LayerNorm,
GELU, audio frame embeddings in place of tokens) in the port against the JAX
package, on the CPU.

``layernorm`` is held to the reference op by op; the SMOKE forward to
``LOGIT_ATOL`` on both sides of ``CHUNKED_ATTN_THRESHOLD`` (shrunk, with the
attention blocks, on both sides by ``monkeypatch`` so the blockwise path runs
over several q and kv blocks at SMOKE size). An encoder has no decode: the
port's engine and tiered step refuse it with ``ValueError`` at construction,
where the reference engine accepts it and fails in prefill (ROADMAP §3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import inputs as jinputs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving.engine import TieredEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, TierScapeRunConfig  # noqa: E402
from repro_torch.configs import get as port_get  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model, attention, inputs, layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402

NAME = "hubert_xlarge"
LOGIT_ATOL = 0.0625  # four bf16 ulps at |logit| < 4 (test_torch_model.py)
SEQ, BATCH_SEED = 64, 3
# (CHUNKED_ATTN_THRESHOLD, Q_BLOCK, KV_BLOCK): the reference's (exact path
# at SEQ), and shrunk so SEQ runs blockwise over 4 q blocks x 2 kv blocks.
PATHS = {"exact": (2048, 512, 1024), "chunked": (32, 16, 32)}


@pytest.fixture(scope="module")
def encoder():
    cfg = get_smoke(NAME)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    # Non-trivial LayerNorm scale/bias and biases in both trees (the
    # reference inits them to ones and zeros).
    rng = np.random.default_rng(12)

    def seeded(path_j, path_t, scale, offset):
        shape = path_j[0][path_j[1]].shape
        w = (offset + rng.normal(0, scale, shape)).astype(np.float32)
        path_j[0][path_j[1]] = jnp.asarray(w, path_j[0][path_j[1]].dtype)
        path_t[0][path_t[1]] = torch.from_numpy(w).to(path_t[0][path_t[1]].dtype)

    for norm in ("norm1", "norm2"):
        seeded((jp["blocks"][norm], "scale"), (tp["blocks"][norm], "scale"), 0.2, 1.0)
        seeded((jp["blocks"][norm], "bias"), (tp["blocks"][norm], "bias"), 0.1, 0.0)
    for b in ("b_up", "b_down"):
        seeded((jp["blocks"]["ffn"], b), (tp["blocks"]["ffn"], b), 0.1, 0.0)
    return cfg, jm, jp, Model(port_smoke(NAME), device="cpu"), tp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_arch_is_registered_as_in_the_reference():
    assert NAME in ARCH_IDS
    assert dataclasses.asdict(port_get(NAME)) == dataclasses.asdict(jget(NAME))
    assert dataclasses.asdict(port_smoke(NAME)) == dataclasses.asdict(get_smoke(NAME))
    cfg = port_get(NAME)
    assert cfg.family == "encoder" and not cfg.causal and cfg.norm == "layernorm"
    assert cfg.head_dim_() == 80 and not cfg.is_decoder and cfg.has_attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """f32 mean/var, rsqrt(var + eps), scale and bias, cast back: to 2e-6 in
    f32 and one bf16 ulp in bf16; ``apply_norm`` and ``make_norm_params``
    take the layernorm branch."""
    rng = np.random.default_rng(7)
    x = (3.0 + rng.normal(0, 2, (2, 9, 64))).astype(np.float32)
    params = {"scale": rng.normal(1, 0.2, 64).astype(np.float32),
              "bias": rng.normal(0, 0.1, 64).astype(np.float32)}
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jlayers.layernorm({k: jnp.asarray(v) for k, v in params.items()}, jx, 1e-5)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    got = layers.layernorm(tparams, tx, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 1 / 32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    assert torch.equal(layers.apply_norm("layernorm", tparams, tx, 1e-5), got)
    made = layers.make_norm_params("layernorm", 64, (3,))
    ref = jlayers.make_norm_params("layernorm", 64)
    assert set(made) == set(ref) == {"scale", "bias"}
    assert made["scale"].shape == (3, 64) and made["scale"].dtype == torch.float32
    assert bool((made["scale"] == 1).all()) and bool((made["bias"] == 0).all())


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sdpa_non_causal_matches_reference(path, monkeypatch):
    """Bidirectional attention in f32, exact and blockwise, against the
    reference's same path."""
    threshold, q_blk, kv_blk = PATHS[path]
    for mod in (jattn, attention):
        monkeypatch.setattr(mod, "Q_BLOCK", q_blk)
        monkeypatch.setattr(mod, "KV_BLOCK", kv_blk)
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(0, 1, (2, SEQ, 4, 16)).astype(np.float32) for _ in range(3))
    fn_j = jattn._sdpa_chunked if path == "chunked" else jattn._sdpa
    fn_t = attention._sdpa_chunked if path == "chunked" else attention._sdpa
    want = fn_j(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    got = fn_t(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    causal = fn_t(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True)
    assert float((causal - got).abs().max()) > 0.1  # the mask is off


def test_params_carry_across_bit_for_bit(encoder):
    """LayerNorm dicts, GELU biases and the encoder's lm_head carry across;
    the port's own init builds the same tree."""
    cfg, jm, jp, tm, tp = encoder
    own = tm.init(0)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(leaves) == len(jax.tree_util.tree_leaves(own))
    for path, leaf in leaves:
        np.testing.assert_array_equal(_f32(_leaf(tp, path)), _f32(leaf), err_msg=str(path))
        mine = _leaf(own, path)
        assert tuple(mine.shape) == leaf.shape, path
        assert str(mine.dtype).split(".")[-1] == str(leaf.dtype), path
    assert set(own["final_norm"]) == {"scale", "bias"} and "lm_head" in own


@pytest.mark.parametrize("path", sorted(PATHS))
def test_forward_matches_reference(encoder, path, monkeypatch):
    """The SMOKE forward on an audio batch (frame embeddings), non-causal,
    on the exact and the blockwise attention path: logits within
    ``LOGIT_ATOL``."""
    cfg, jm, jp, tm, tp = encoder
    threshold, q_blk, kv_blk = PATHS[path]
    for mod in (jattn, attention):
        monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", threshold)
        monkeypatch.setattr(mod, "Q_BLOCK", q_blk)
        monkeypatch.setattr(mod, "KV_BLOCK", kv_blk)
    jb = jinputs.make_train_batch(cfg, 2, SEQ, seed=BATCH_SEED)
    tb = inputs.make_train_batch(port_smoke(NAME), 2, SEQ, seed=BATCH_SEED, device="cpu")
    assert "tokens" not in tb and tb["embeds"].dtype == torch.bfloat16
    jl, _ = jm.forward(jp, jb)
    tl, taux = tm.forward(tp, tb)
    assert tl.shape == (2, SEQ, cfg.vocab_size) and tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
    assert float(taux["load_balance"]) == 0.0


def test_engines_refuse_the_encoder(encoder):
    """The port refuses an encoder at construction (engine and tiered step),
    and its ``prefill``/``decode_step`` raise as the reference's do; the
    reference engine accepts it and fails in prefill with KeyError 'embeds'."""
    cfg, jm, jp, tm, tp = encoder
    ts = TierScapeRunConfig(enabled=True)
    with pytest.raises(ValueError, match="encoder"):
        TieredEngine(tm, tp, batch_slots=2, ts=ts, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        serve.make_tiered_decode_step(tm, ts, device="cpu")
    state = tm.init_cache(1, 16)
    with pytest.raises(ValueError, match="prefill undefined"):
        tm.prefill(tp, {"tokens": torch.ones((1, 8), dtype=torch.int64)}, state)
    with pytest.raises(ValueError, match="decode undefined"):
        tm.decode_step(tp, torch.ones((1, 1), dtype=torch.int64), state)
    je = JEngine(jm, jp, batch_slots=2, page_tokens=8, max_seq_len=64, recent_window=16)
    je.submit(np.arange(1, 20) % cfg.vocab_size, max_new_tokens=2)
    with pytest.raises(KeyError, match="embeds"):
        je.run(max_steps=2)
