"""The port's dense model against the JAX package, on the CPU.

Weights come from ``repro.models.Model(cfg).init(jax.random.PRNGKey(0))``
and are carried across bit for bit (``params_from_numpy``). Logits are held
to atol 0.0625: four bf16 ulps at the smoke model's logit magnitude (< 4).
Both frameworks round activations to bf16 at the same points when run op by
op, but XLA keeps excess f32 precision inside the reference's scanned and
fused computations and skips some of those roundings; each skipped rounding
moves a value by at most half an ulp, and the two layers compound them (the
largest difference seen across seeds is two ulps). Greedy tokens must be
equal: the seeds are chosen so that the reference's top-1 margin exceeds that
tolerance at every step (``PRNGKey(1)`` with prompt seed 3, the reference's
own engine test seed, lands on a real one-ulp tie: see ROADMAP §3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy  # noqa: E402

LOGIT_ATOL = 0.0625
PARAM_KEY, PROMPT_SEED = 0, 1


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke("qwen1_5_4b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tm = Model(port_smoke("qwen1_5_4b"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, tm, tp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_params_carry_across_bit_for_bit(models):
    cfg, jm, jp, tm, tp = models
    assert tp["embed"].dtype == torch.bfloat16 and tp["blocks"]["norm1"].dtype == torch.float32
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(_f32(node), _f32(leaf), err_msg=str(path))
    # bf16 -> uint16 view -> bf16 is exact, including odd bit patterns.
    bits = np.arange(0, 65536, 257, dtype=np.uint16)
    jb = jnp.asarray(bits).view(jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(jb))
    np.testing.assert_array_equal(t.view(torch.uint16).numpy().astype(np.uint16), bits)


def test_prefill_and_greedy_decode_match_reference(models):
    cfg, jm, jp, tm, tp = models
    prompt = np.random.default_rng(PROMPT_SEED).integers(1, cfg.vocab_size, 24)
    jstate = jm.init_cache(1, 64)
    jl, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None], jnp.int32)}, jstate)
    tstate = tm.init_cache(1, 64)
    tl, tstate = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])}, tstate)
    assert tl.shape == (1, 1, cfg.vocab_size) and tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(_f32(tstate.k_cache), _f32(jstate.k_cache), atol=LOGIT_ATOL)
    jt = [int(jnp.argmax(jl[0, -1]))]
    tt = [int(torch.argmax(tl[0, -1]))]
    for _ in range(8):
        jl, jstate = jm.decode_step(jp, jnp.asarray([[jt[-1]]], jnp.int32), jstate)
        tl, tstate = tm.decode_step(tp, torch.as_tensor([[tt[-1]]]), tstate)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
        jt.append(int(jnp.argmax(jl[0, 0])))
        tt.append(int(torch.argmax(tl[0, 0])))
    assert tt == jt
    assert tstate.cache_len == int(jstate.cache_len) == 24 + 8


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_paths_match_reference(causal):
    """f32 inputs (no bf16 rounding in play): the exact and the blockwise
    path against the reference's exact path."""
    rng = np.random.default_rng(5)
    s, h, kv, hd = 1024, 4, 2, 16
    q, k, v = (rng.normal(0, 1, (1, s, n, hd)).astype(np.float32) for n in (h, kv, kv))
    want = np.asarray(jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(attention._sdpa(tq, tk, tv, causal).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(attention._sdpa_chunked(tq, tk, tv, causal).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    ke, ve = attention._maybe_expand_kv(tq, tk, tv)
    assert ke is tk and ve is tv  # one device: no GQA expansion
    ke, _ = attention._maybe_expand_kv(tq, tk, tv, tp=4)
    assert ke.shape[2] == h


def test_model_defaults_to_cuda_and_rejects_unported_flavors():
    """The card by default; an unknown family raises ``ValueError(family)``
    as the reference's ``Model.init`` does (every family of the reference is
    ported)."""
    cfg = port_smoke("qwen1_5_4b")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Model(cfg)
    for family in ("retnet", "diffusion"):
        with pytest.raises(ValueError, match=family):
            Model(dataclasses.replace(cfg, family=family), device="cpu")
    for change in (dict(family="moe", moe=port_smoke("dbrx_132b").moe),
                   dict(norm="layernorm"), dict(mrope=True, mrope_sections=(4, 6, 6))):
        Model(dataclasses.replace(cfg, **change), device="cpu")


def test_seeded_init_is_deterministic_and_in_reference_layout():
    cfg = port_smoke("qwen1_5_4b")
    m = Model(cfg, device="cpu")
    a, b = m.init(7), m.init(7)
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["embed"], m.init(8)["embed"])
    L, d, h, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim_()
    assert a["blocks"]["attn"]["wq"].shape == (L, d, h, hd)
    assert a["blocks"]["attn"]["wo"].shape == (L, h, hd, d)
    assert a["blocks"]["attn"]["bq"].shape == (L, h, hd)
    assert a["blocks"]["ffn"]["w_down"].shape == (L, cfg.d_ff, d)
    assert a["lm_head"].shape == (d, cfg.vocab_size)
    # Truncated normal at +-2 std of 1/sqrt(fan_in).
    w = a["blocks"]["attn"]["wq"].float()
    assert float(w.abs().max()) <= 2.0 / d**0.5 * 1.01
