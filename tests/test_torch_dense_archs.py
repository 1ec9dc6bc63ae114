"""The GQA dense archs (``qwen3_32b`` with qk-norm, ``internlm2_20b``,
``command_r_35b``) in the port against the JAX package, on the CPU.

For each SMOKE config: weights from ``repro.models.Model(cfg).init(
jax.random.PRNGKey(0))`` carried across bit for bit (``params_from_numpy``);
where the config has qk-norm, ``q_norm``/``k_norm`` are then overwritten in
both trees with the same seeded non-unit f32 values (the reference inits them
to ones, which would leave the norm's weight untested). The q/k/v projection
is held to 2e-4 in f32; prefill and greedy-decode logits to ``LOGIT_ATOL``
with equal greedy tokens, at the bars of ``test_torch_model.py``. The
``qwen3_32b`` SMOKE engine (GQA group 2) runs in lockstep with the JAX
engine at the settings of ``tests/test_system.py::test_engine_end_to_end``,
serially and on the async + prefetch path: tokens and placements after every
step must be equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import TierScapeRunConfig as JRunConfig  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.serving.engine import TieredEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, TierScapeRunConfig  # noqa: E402
from repro_torch.configs import get as port_get  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402

ARCHS = ["qwen3_32b", "internlm2_20b", "command_r_35b"]
LOGIT_ATOL = 0.0625  # four bf16 ulps at |logit| < 4 (test_torch_model.py)
PARAM_KEY, PROMPT_SEED, NORM_SEED = 0, 1, 11
# tests/test_system.py::test_engine_end_to_end
ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
RUN = dict(enabled=True, policy="analytical", alpha=0.3, window_steps=6, faults=False)
NEW_TOKENS = 16


def _set_qk_norm(cfg, jp, tp):
    """The same seeded non-unit f32 q_norm/k_norm [L, hd] in both trees."""
    rng = np.random.default_rng(NORM_SEED)
    for name in ("q_norm", "k_norm"):
        w = rng.uniform(0.5, 1.5, (cfg.n_layers, cfg.head_dim_())).astype(np.float32)
        jp["blocks"]["attn"][name] = jnp.asarray(w)
        tp["blocks"]["attn"][name] = torch.from_numpy(w.copy())


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    cfg = get_smoke(name)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    if cfg.qk_norm:
        _set_qk_norm(cfg, jp, tp)
    return name, cfg, jm, jp, Model(port_smoke(name), device="cpu"), tp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_archs_are_registered_as_in_the_reference():
    """The three configs are the reference's, full and SMOKE, and GQA."""
    for name in ARCHS:
        assert name in ARCH_IDS
        assert dataclasses.asdict(port_get(name)) == dataclasses.asdict(jget(name))
        assert dataclasses.asdict(port_smoke(name)) == dataclasses.asdict(get_smoke(name))
        for cfg in (port_get(name), port_smoke(name)):
            assert cfg.n_kv_heads < cfg.n_heads and cfg.n_heads % cfg.n_kv_heads == 0
    assert port_smoke("qwen3_32b").qk_norm and port_smoke("command_r_35b").tie_embeddings


def test_model_builds_each_arch_and_still_rejects_unported_flavors():
    """``Model`` builds the three archs on the CPU (qk-norm is served); every
    flavor of the reference's archs is ported now, so what it still refuses
    is an unknown family (``ValueError(family)``, as the reference)."""
    for name in ARCHS:
        Model(port_smoke(name), device="cpu")
    cfg = port_smoke("qwen3_32b")
    for family in ("retnet", "rwkv"):
        with pytest.raises(ValueError, match=family):
            Model(dataclasses.replace(cfg, family=family), device="cpu")


def test_params_carry_across_bit_for_bit(arch):
    """The converted tree equals the reference's leaf for leaf (the seeded
    q_norm/k_norm included), and the port's own init builds the same tree:
    the same leaves, shapes and dtypes (qk-norm: f32 ones [L, hd])."""
    name, cfg, jm, jp, tm, tp = arch
    own = tm.init(0)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(leaves) == len(jax.tree_util.tree_leaves(own))
    for path, leaf in leaves:
        node = _leaf(tp, path)
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(_f32(node), _f32(leaf), err_msg=str(path))
        mine = _leaf(own, path)
        assert tuple(mine.shape) == leaf.shape, path
        assert str(mine.dtype).split(".")[-1] == str(leaf.dtype), path
    attn = own["blocks"]["attn"]
    assert ("q_norm" in attn) == cfg.qk_norm
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            assert attn[n].dtype == torch.float32 and attn[n].shape == (cfg.n_layers,
                                                                        cfg.head_dim_())
            assert bool((attn[n] == 1).all())
            assert not bool((tp["blocks"]["attn"][n] == 1).all())
    assert ("lm_head" in own) == (not cfg.tie_embeddings)


def test_project_qkv_matches_reference(arch):
    """q, k, v of one layer (biases, qk-norm, rope) in f32 against the
    reference's ``_project_qkv``, to 2e-4."""
    name, cfg, jm, jp, tm, tp = arch
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 7, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(5, 12)]).astype(np.int32)
    jlayer = {k: jnp.asarray(v[1], jnp.float32) for k, v in jp["blocks"]["attn"].items()}
    tlayer = {k: v[1].float() for k, v in tp["blocks"]["attn"].items()}
    want = jattn._project_qkv(jlayer, cfg, jnp.asarray(x), jnp.asarray(pos),
                              jattn.ActivationSharding())
    got = attention._project_qkv(tlayer, port_smoke(name), torch.from_numpy(x),
                                 torch.from_numpy(pos))
    for what, g, w in zip("qkv", got, want):
        assert tuple(g.shape) == w.shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4, err_msg=what)


def test_prefill_and_greedy_decode_match_reference(arch):
    name, cfg, jm, jp, tm, tp = arch
    prompt = np.random.default_rng(PROMPT_SEED).integers(1, cfg.vocab_size, 24)
    jstate = jm.init_cache(1, 64)
    jl, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None], jnp.int32)}, jstate)
    tstate = tm.init_cache(1, 64)
    tl, tstate = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])}, tstate)
    assert tl.shape == (1, 1, cfg.vocab_size) and tl.dtype == torch.bfloat16
    assert tstate.k_cache.shape[3] == cfg.n_kv_heads
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


# (async + prefetch, alpha, prompt seed): the reference test's alpha 0.3
# keeps every page warm in these 15 steps, so alpha 0 adds a run whose
# windows migrate pages to the host tier (sentinels, swap-ins, overlapped
# cohorts). Its prompt seed 0 meets a one-ulp bf16 tie at step 9 (ROADMAP §3).
MODES = {"serial": (False, 0.3, 0), "async_prefetch": (True, 0.3, 0),
         "async_prefetch_alpha0": (True, 0.0, 1)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_qwen3_engine_matches_reference(mode):
    """The qwen3_32b SMOKE engines in lockstep: greedy tokens, physical and
    desired placements after every step (so at every window), and the stats
    counters equal; on the async path the overlap and prefetch counters too."""
    async_prefetch, alpha, prompt_seed = MODES[mode]
    cfg = get_smoke("qwen3_32b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    _set_qk_norm(cfg, jp, tp)
    run = dict(RUN, alpha=alpha, async_migration=async_prefetch, prefetch=async_prefetch)
    je = JEngine(jm, jp, ts=JRunConfig(**run), **ENGINE)
    te = TieredEngine(Model(port_smoke("qwen3_32b"), device="cpu"), tp,
                      ts=TierScapeRunConfig(**run), device="cpu", **ENGINE)
    rng = np.random.default_rng(prompt_seed)
    prompts = [rng.integers(1, cfg.vocab_size, 24) for _ in range(2)]
    jreqs = [je.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    levels = set()
    while any(s is not None for s in je.slots) or je.queue:
        assert je.stats.steps < 40
        je._fill_slots()
        te._fill_slots()
        je.step()
        te.step()
        step = je.stats.steps
        np.testing.assert_array_equal(te.cache.physical, je.cache.physical, err_msg=f"step {step}")
        np.testing.assert_array_equal(te.cache.manager.placement, je.cache.manager.placement,
                                      err_msg=f"step {step}")
        levels.update(te.cache.physical[te.cache._page_exists].tolist())
    js, ts = je.finish(), te.finish()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == NEW_TOKENS and r.done for r in treqs)
    assert ts.windows >= 1 and ts.completed == 2
    for f in ("steps", "windows", "migrations", "completed", "overlapped_steps",
              "prefetch_staged", "prefetch_hits", "prefetch_misses", "attn_launches"):
        assert getattr(ts, f) == getattr(js, f), f
    assert te.cache.kernel_dispatches == je.cache.kernel_dispatches
    assert ts.tco_savings_pct == pytest.approx(js.tco_savings_pct, rel=1e-12)
    if alpha == 0.0:
        assert ts.migrations > 0 and ts.overlapped_steps > 0
        assert 4 in levels  # the int4 host tier
