"""The port's pure-SSM family (Mamba2: SSD blocks, no attention) against the
JAX package, on the CPU, on the ``mamba2_780m`` SMOKE config.

Weights come from the reference's ``Model.init(PRNGKey(k))``, carried across
bit for bit. In f32 (every parameter and state cast to f32 in both
packages) the forward, the recurrent prefill's states and its last logits,
and eight decode steps are held op by op to rtol = atol = 2e-4, the bar of
the SSM modules in ``test_torch_hybrid.py``; the prompts are 45 tokens, not
a multiple of the SMOKE's SSD chunk of 32, so the zero-padded tail (dt = 0)
is exercised. In bf16 the port's decode logits are held to its own parallel
forward at the reference's bar of 0.15 (``tests/test_archs.py``), and its
prefill logits to the reference's at the bf16 bar of ``test_torch_model.py``
(atol 0.0625) with greedy tokens equal. Both serving engines refuse the
config: an SSM has no KV to tier.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import TierScapeRunConfig, get, get_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_VS_FORWARD = 0.15  # tests/test_archs.py::test_smoke_decode_matches_forward
LOGIT_ATOL = 0.0625  # four bf16 ulps at |logit| < 4 (test_torch_model.py)
PARAM_KEY, PROMPT_SEED, SEQ = 0, 3, 45
ARCH = "mamba2_780m"


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def models():
    cfg = jsmoke(ARCH)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tm = Model(get_smoke(ARCH), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def f32_models(models):
    cfg, jm, jp, tm, _ = models
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    tp32 = params_from_numpy(jax.tree.map(np.asarray, jp32))
    return cfg, jm, jp32, tm, tp32


def _prompts(cfg, batch=2, seq=SEQ):
    return np.random.default_rng(PROMPT_SEED).integers(1, cfg.vocab_size, (batch, seq))


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_mamba2_configs_equal_reference(which):
    j = jget(ARCH) if which == "CONFIG" else jsmoke(ARCH)
    t = get(ARCH) if which == "CONFIG" else get_smoke(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert not t.has_attention and t.family == "ssm"
    if which == "CONFIG":
        s = t.ssm
        assert (t.n_layers, t.d_model, t.vocab_size, s.d_state, s.head_dim, s.expand,
                s.chunk) == (48, 1536, 50280, 128, 64, 2, 128)


def test_ssm_params_convert_in_reference_layout(models):
    """The converted tree is the reference's leaf for leaf, and the port's
    own seeded init builds the same layout (no shared block, tied head)."""
    cfg, jm, jp, tm, tp = models
    own = tm.init(0)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node, mine = tp, own
        for k in path:
            node, mine = node[k.key], mine[k.key]
        assert tuple(node.shape) == leaf.shape == tuple(mine.shape), path
        assert node.dtype == mine.dtype, path
        np.testing.assert_array_equal(_f32(node), _f32(leaf), err_msg=str(path))
    assert set(tp) == set(own) == {"embed", "blocks", "final_norm"}
    assert set(tp["blocks"]) == {"norm", "mixer"}


def test_ssm_forward_matches_reference_f32(f32_models):
    cfg, jm, jp, tm, tp = f32_models
    tokens = _prompts(cfg)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, aux = tm.forward(tp, {"tokens": torch.as_tensor(tokens)})
    assert aux == {}
    assert tl.shape == (2, SEQ, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)


def test_ssm_prefill_and_decode_match_reference_f32(f32_models):
    """The recurrent prefill's conv/SSM states and last logits, then eight
    decode steps (logits and states after each)."""
    cfg, jm, jp, tm, tp = f32_models
    tokens = _prompts(cfg)
    jstate = jm.init_cache(2, SEQ + 8, dtype=jnp.float32)
    jl, jstate = jm.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)}, jstate)
    tstate = tm.init_cache(2, SEQ + 8, dtype=torch.float32)
    assert tstate.k_cache.shape[0] == 0  # no attention layer, no KV
    tl, tstate = tm.prefill(tp, {"tokens": torch.as_tensor(tokens)}, tstate)
    assert tl.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    for f in ("conv_state", "ssm_state"):
        assert tuple(getattr(tstate, f).shape) == getattr(jstate, f).shape, f
        np.testing.assert_allclose(_f32(getattr(tstate, f)), _f32(getattr(jstate, f)),
                                   err_msg=f, **F32_TOL)
    tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
    for i in range(8):
        jl, jstate = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jstate)
        tl, tstate = tm.decode_step(tp, torch.as_tensor(tok), tstate)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **F32_TOL)
        np.testing.assert_allclose(tstate.ssm_state.numpy(), np.asarray(jstate.ssm_state),
                                   err_msg=f"step {i}", **F32_TOL)
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
    assert tstate.cache_len == int(jstate.cache_len) == SEQ + 8


@pytest.mark.parametrize("seq", [16, SEQ])
def test_ssm_decode_matches_forward(models, seq):
    """bf16, the port alone: token-by-token decode against the parallel
    (chunked SSD) forward over the same tokens, at the reference's bar."""
    cfg, _, _, tm, tp = models
    tokens = torch.as_tensor(_prompts(cfg, seq=seq))
    full = tm.forward(tp, {"tokens": tokens})[0]
    state = tm.init_cache(2, seq + 2)
    outs = []
    for i in range(seq):
        lg, state = tm.decode_step(tp, tokens[:, i: i + 1], state)
        outs.append(lg)
    err = float((full.float() - torch.cat(outs, 1).float()).abs().max())
    assert err < DECODE_VS_FORWARD, err
    assert state.conv_state.dtype == torch.bfloat16 and state.ssm_state.dtype == torch.float32


def test_ssm_prefill_and_greedy_decode_match_reference_bf16(models):
    cfg, jm, jp, tm, tp = models
    prompt = _prompts(cfg, batch=1, seq=24)
    jstate = jm.init_cache(1, 40)
    jl, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)}, jstate)
    tstate = tm.init_cache(1, 40)
    tl, tstate = tm.prefill(tp, {"tokens": torch.as_tensor(prompt)}, tstate)
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
    jt, tt = [int(jnp.argmax(jl[0, -1]))], [int(torch.argmax(tl[0, -1]))]
    for _ in range(8):
        jl, jstate = jm.decode_step(jp, jnp.asarray([[jt[-1]]], jnp.int32), jstate)
        tl, tstate = tm.decode_step(tp, torch.as_tensor([[tt[-1]]]), tstate)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
        jt.append(int(jnp.argmax(jl[0, 0])))
        tt.append(int(torch.argmax(tl[0, 0])))
    assert tt == jt


def test_both_engines_refuse_the_ssm_config(models):
    """Neither engine tiers an attention-free model: the reference asserts,
    the port raises ValueError with the reference's message, and so does
    its tiered decode step."""
    from repro.serving.engine import TieredEngine as JEngine
    from repro_torch.runtime import serve
    from repro_torch.serving.engine import TieredEngine

    cfg, jm, jp, tm, tp = models
    geom = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
    with pytest.raises(AssertionError, match="needs attention layers"):
        JEngine(jm, jp, **geom)
    with pytest.raises(ValueError, match="tiered KV serving needs attention layers"):
        TieredEngine(tm, tp, ts=TierScapeRunConfig(enabled=True), device="cpu", **geom)
    with pytest.raises(ValueError, match="needs attention layers"):
        serve.make_tiered_decode_step(tm, TierScapeRunConfig(enabled=True), device="cpu")
