"""The port's hybrid family (Zamba2: Mamba2 backbone + a shared attention
block) against the JAX package, on the CPU.

SSM modules (``_causal_conv``, ``ssd_chunked``, ``ssm_block``,
``ssm_decode_step``) run in f32 on the ``zamba2_1_2b`` SMOKE config with
numpy-seeded inputs and are held to rtol = atol = 2e-4. The whole model
(weights from the reference's ``Model.init(PRNGKey(k))``, carried across bit
for bit) is held to the bf16 bar of ``test_torch_model.py``: logits within
atol 0.0625, greedy tokens equal, on seeds checked to be free of ties.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers, mlp, ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SSM_TOL = dict(rtol=2e-4, atol=2e-4)
LOGIT_ATOL = 0.0625
# Eight bf16 ulps (absolute at |x| < 4, relative above): the largest cache
# differences seen after a 24-token recurrent prefill are 0.068 (SSM state)
# and 0.043 (K/V); after 40 tokens, 0.154 at an SSM state of 7.9 (2%).
CACHE_TOL = dict(atol=0.125, rtol=2.0**-5)
PARAM_KEY, PROMPT_SEED = 0, 1


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree_f32(tree):
    """The reference's parameter tree with every leaf cast to f32 (numpy)."""
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


@pytest.fixture(scope="module")
def mixer():
    """One SSM layer's mixer params in f32, both packages."""
    cfg = get_smoke("zamba2_1_2b")
    jp = _tree_f32(jssm.init_ssm_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(0)
    # Non-trivial dt_bias / A_log / D / norm so every term of the scan counts.
    nh = cfg.ssm.n_heads(cfg.d_model)
    jp["dt_bias"] = rng.normal(0, 0.5, nh).astype(np.float32)
    jp["A_log"] = rng.normal(0, 0.5, nh).astype(np.float32)
    jp["D"] = rng.normal(1, 0.2, nh).astype(np.float32)
    jp["norm_w"] = rng.normal(1, 0.1, jp["norm_w"].shape).astype(np.float32)
    jp["conv_b"] = rng.normal(0, 0.1, jp["conv_b"].shape).astype(np.float32)
    return cfg, port_smoke("zamba2_1_2b"), jp, params_from_numpy(jp)


def test_zamba2_configs_equal_reference():
    from repro.configs import get as jget
    from repro_torch.configs import get

    for j, t in ((jget("zamba2_1_2b"), get("zamba2_1_2b")),
                 (get_smoke("zamba2_1_2b"), port_smoke("zamba2_1_2b"))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert jtf._attn_layer_count(j) == -(-t.n_layers // t.hybrid_attn_every)
    assert jtf._attn_layer_count(jget("zamba2_1_2b")) == 7


@pytest.mark.parametrize("seq", [32, 45])
def test_causal_conv_matches_reference(seq):
    rng = np.random.default_rng(seq)
    x = rng.normal(0, 1, (2, seq, 24)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, 24)).astype(np.float32)
    b = rng.normal(0, 0.1, 24).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSM_TOL)


def test_segsum_matches_reference():
    x = np.random.default_rng(1).normal(0, 1, (3, 8)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **SSM_TOL)
    assert np.exp(got)[~fin].max() == 0.0  # exp(-inf) = 0 above the diagonal


@pytest.mark.parametrize("seq, chunk", [(64, 32), (45, 32), (7, 32), (50, 16)])
def test_ssd_chunked_matches_reference(seq, chunk):
    """Lengths that are and are not a multiple of ``chunk`` (the zero-padded
    tail with dt = 0 leaves the final state exact)."""
    rng = np.random.default_rng(seq * chunk)
    bsz, h, p, g, n = 2, 8, 16, 1, 16
    x = rng.normal(0, 1, (bsz, seq, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-1, 1, (bsz, seq, h)))).astype(np.float32)
    a = -np.exp(rng.normal(0, 0.5, h)).astype(np.float32)
    b = rng.normal(0, 1, (bsz, seq, g, n)).astype(np.float32)
    c = rng.normal(0, 1, (bsz, seq, g, n)).astype(np.float32)
    jy, js = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, b, c)), chunk)
    ty, ts = ssm.ssd_chunked(*(torch.from_numpy(v) for v in (x, dt, a, b, c)), chunk)
    assert ty.shape == (bsz, seq, h, p) and ts.shape == (bsz, h, p, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSM_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SSM_TOL)


@pytest.mark.parametrize("seq", [32, 45])
def test_ssm_block_matches_reference(mixer, seq):
    jcfg, tcfg, jp, tp = mixer
    x = np.random.default_rng(seq).normal(0, 1, (2, seq, jcfg.d_model)).astype(np.float32)
    want = jssm.ssm_block(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    got = ssm.ssm_block(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSM_TOL)


def test_ssm_decode_step_matches_reference(mixer):
    """Eight recurrent steps from a random state against the reference's."""
    jcfg, tcfg, jp, tp = mixer
    s = jcfg.ssm
    rng = np.random.default_rng(7)
    di = s.d_inner(jcfg.d_model)
    cconv = di + 2 * s.n_groups * s.d_state
    conv = rng.normal(0, 1, (2, s.conv_kernel - 1, cconv)).astype(np.float32)
    sst = rng.normal(0, 1, (2, s.n_heads(jcfg.d_model), s.head_dim, s.d_state)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, jp)
    jc, js = jnp.asarray(conv), jnp.asarray(sst)
    tc, ts = torch.from_numpy(conv), torch.from_numpy(sst)
    for i in range(8):
        x = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc, js = jssm.ssm_decode_step(jparams, jcfg, jnp.asarray(x), jc, js)
        ty, tc, ts = ssm.ssm_decode_step(tp, tcfg, torch.from_numpy(x), tc, ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), err_msg=f"step {i}", **SSM_TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), err_msg=f"step {i}", **SSM_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), err_msg=f"step {i}", **SSM_TOL)
    assert tc.dtype == torch.float32 and ts.dtype == torch.float32


def test_gelu_mlp_matches_reference():
    from repro.models import layers as jlayers
    from repro.models import mlp as jmlp

    cfg = get_smoke("zamba2_1_2b")
    jp = jmlp.init_mlp_params(jax.random.PRNGKey(2), cfg)
    assert set(jp) == {"w_up", "b_up", "w_down", "b_down"}
    rng = np.random.default_rng(2)
    jp = dict(jp, b_up=jnp.asarray(rng.normal(0, 0.1, cfg.d_ff), jnp.bfloat16),
              b_down=jnp.asarray(rng.normal(0, 0.1, cfg.d_model), jnp.bfloat16))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(
        _f32(layers.gelu(torch.from_numpy(x).to(torch.bfloat16))), _f32(jlayers.gelu(xb)))
    want = jmlp.mlp(jp, cfg, xb)
    got = mlp.mlp(tp, port_smoke("zamba2_1_2b"), torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LOGIT_ATOL, rtol=0)
    init = mlp.init_mlp_params(torch.Generator().manual_seed(0), port_smoke("zamba2_1_2b"),
                               lead=(3,))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "w_up": (3, cfg.d_model, cfg.d_ff), "b_up": (3, cfg.d_ff),
        "w_down": (3, cfg.d_ff, cfg.d_model), "b_down": (3, cfg.d_model)}


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke("zamba2_1_2b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tm = Model(port_smoke("zamba2_1_2b"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jm, jp, tm, tp


def test_hybrid_params_convert_in_reference_layout(models):
    """The converted tree is the reference's, leaf for leaf, and the port's
    own seeded init builds the same layout."""
    cfg, jm, jp, tm, tp = models
    own = tm.init(0)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node, mine = tp, own
        for k in path:
            node, mine = node[k.key], mine[k.key]
        assert tuple(node.shape) == leaf.shape == tuple(mine.shape), path
        assert node.dtype == mine.dtype, path
        np.testing.assert_array_equal(_f32(node), _f32(leaf), err_msg=str(path))
    assert set(tp) == set(own) == {"embed", "blocks", "shared", "final_norm"}
    assert set(tp["blocks"]["mixer"]) == {"in_proj", "conv_w", "conv_b", "dt_bias", "A_log",
                                          "D", "norm_w", "out_proj"}
    assert {"b_up", "b_down"} <= set(tp["shared"]["ffn"])


def test_hybrid_prefill_and_greedy_decode_match_reference(models):
    cfg, jm, jp, tm, tp = models
    prompt = np.random.default_rng(PROMPT_SEED).integers(1, cfg.vocab_size, 24)
    jstate = jm.init_cache(1, 64)
    jl, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None], jnp.int32)}, jstate)
    tstate = tm.init_cache(1, 64)
    tl, tstate = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])}, tstate)
    assert tl.shape == (1, 1, cfg.vocab_size) and tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
    # The caches come out of 24 recurrent steps whose bf16 roundings XLA
    # partly skips inside its scan (ROADMAP §3): held to CACHE_TOL.
    assert tstate.k_cache.shape == jstate.k_cache.shape
    for f in ("k_cache", "v_cache", "conv_state", "ssm_state"):
        np.testing.assert_allclose(_f32(getattr(tstate, f)), _f32(getattr(jstate, f)),
                                   err_msg=f, **CACHE_TOL)
    assert tstate.conv_state.dtype == torch.bfloat16 and tstate.ssm_state.dtype == torch.float32
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


def test_hybrid_forward_matches_reference(models):
    """The parallel forward (chunked SSD + full attention) at a length that
    is not a multiple of the SMOKE chunk."""
    cfg, jm, jp, tm, tp = models
    prompt = np.random.default_rng(PROMPT_SEED + 1).integers(1, cfg.vocab_size, (2, 45))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tl, aux = tm.forward(tp, {"tokens": torch.as_tensor(prompt)})
    assert aux == {}
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The hybrid serving loop against the JAX engine
# ---------------------------------------------------------------------------

ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
# The default async + prefetch path with the host tiers on the cxl_hw
# expander; alpha 0.05 spreads pages over warm int8, cold int4 and the int4
# host tier, so windows run transcoding cohorts, host sentinels and swap-ins.
RUN = dict(enabled=True, policy="analytical", alpha=0.05, window_steps=6,
           async_migration=True, prefetch=True, faults=False, host_media_device="cxl_hw")
ENGINE_PROMPT_SEED, NEW_TOKENS = 2, 20
HOT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def lockstep(models):
    from repro.configs import TierScapeRunConfig as JRunConfig
    from repro.serving.engine import TieredEngine as JEngine
    from repro_torch.configs import TierScapeRunConfig
    from repro_torch.serving.engine import TieredEngine

    cfg, jm, jp, tm, tp = models
    je = JEngine(jm, jp, ts=JRunConfig(**RUN), **ENGINE)
    te = TieredEngine(tm, tp, ts=TierScapeRunConfig(**RUN), device="cpu", **ENGINE)
    rng = np.random.default_rng(ENGINE_PROMPT_SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (40, 27, 33)]
    jreqs = [je.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    steps, windows, snapshot, side = [], [], None, None
    while any(s is not None for s in je.slots) or je.queue:
        assert je.stats.steps < 100
        je._fill_slots()
        te._fill_slots()
        if side is None:  # right after the first prefills: the SSM side state
            side = (tuple(np.asarray(a) for a in je.ssm_state),
                    tuple(t.clone() for t in te.ssm_state))
        if je.stats.windows == 2 and snapshot is None:
            tokens = np.zeros((ENGINE["batch_slots"], 1), np.int32)
            for i, r in enumerate(je.slots):
                if r is not None:
                    tokens[i, 0] = r.out_tokens[-1]
            snapshot = (je.cache.state, je.ssm_state, tokens)
        je.step()
        te.step()
        steps.append((je.cache.physical.copy(), te.cache.physical.copy(),
                      je.cache.manager.placement.copy(), te.cache.manager.placement.copy()))
        if te.stats.windows > len(windows):
            windows.append(steps[-1])
    return dict(cfg=cfg, jm=jm, jp=jp, tm=tm, tp=tp, je=je, te=te, jreqs=jreqs, treqs=treqs,
                jstats=je.finish(), tstats=te.finish(), steps=steps, windows=windows,
                snapshot=snapshot, side=side, prompts=prompts)


def test_hybrid_engine_on_cxl_hw_matches_reference(lockstep):
    """Tokens, physical and desired placements after every step (and so at
    every window), the stats, the kernel-dispatch bill, the media queues'
    bytes and busy time, and the cxl_hw device's observed line ratio."""
    ls = lockstep
    je, te = ls["je"], ls["te"]
    assert [r.out_tokens for r in ls["treqs"]] == [r.out_tokens for r in ls["jreqs"]]
    assert all(len(r.out_tokens) == NEW_TOKENS and r.done for r in ls["treqs"])
    for i, (jphys, tphys, jplace, tplace) in enumerate(ls["steps"]):
        np.testing.assert_array_equal(tphys, jphys, err_msg=f"step {i + 1}")
        np.testing.assert_array_equal(tplace, jplace, err_msg=f"step {i + 1}")
    assert len(ls["windows"]) == ls["jstats"].windows >= 5
    levels = set(np.concatenate([w[1] for w in ls["windows"]]).tolist())
    assert {1, 2, 4} <= levels  # warm, cold and host pages all occurred
    js, ts = ls["jstats"], ls["tstats"]
    for f in ("steps", "windows", "migrations", "completed", "overlapped_steps",
              "prefetch_staged", "prefetch_hits", "prefetch_misses", "attn_launches"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.migrations > 0 and ts.overlapped_steps > 0
    assert ts.attn_launches == te.la * ts.steps and te.la == 2
    assert te.cache.kernel_dispatches == je.cache.kernel_dispatches
    assert ts.tco_savings_pct == pytest.approx(js.tco_savings_pct, rel=1e-12)
    for name, jq in je.cache.media_queues.items():
        tq = te.cache.media_queues[name]
        assert tq.bytes_total == jq.bytes_total, name
        assert tq.busy_s == pytest.approx(jq.busy_s, rel=1e-12), name
    jdev, tdev = je.cache.media_queues["cxl_hw"].device, te.cache.media_queues["cxl_hw"].device
    assert tdev.ratio == jdev.ratio
    ring = te.cache.staging_ring
    assert ring.held_slots == 0 and ring.free_slots == ring.n_slots


def test_hybrid_engine_side_state_reuses_prefill(lockstep):
    """The port's engine takes each slot's SSM side state from
    ``Model.prefill`` instead of scanning the prompt a second time. The
    reference engine's second scan gives exactly its prefill's states (so
    reusing them is the same function, within the SSM bar), the port's side
    state is its own prefill's bit for bit, and the two packages' side
    states agree to the bf16 cache bar."""
    ls = lockstep
    jm, jp, tm, tp = ls["jm"], ls["jp"], ls["tm"], ls["tp"]
    (jconv, jssm_), (tconv, tssm) = ls["side"]
    for slot, prompt in enumerate(ls["prompts"][:2]):
        s = len(prompt)
        jst = jm.init_cache(1, max(s + 1, ENGINE["page_tokens"]))
        _, jst = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None], jnp.int32)}, jst)
        np.testing.assert_allclose(jconv[:, slot].astype(np.float32), _f32(jst.conv_state[:, 0]),
                                   **SSM_TOL)
        np.testing.assert_allclose(jssm_[:, slot], _f32(jst.ssm_state[:, 0]), **SSM_TOL)
        tst = tm.init_cache(1, max(s + 1, ENGINE["page_tokens"]))
        _, tst = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])}, tst)
        assert torch.equal(tconv[:, slot], tst.conv_state[:, 0])
        assert torch.equal(tssm[:, slot], tst.ssm_state[:, 0])
        np.testing.assert_allclose(_f32(tconv[:, slot]), jconv[:, slot].astype(np.float32),
                                   **CACHE_TOL)
        np.testing.assert_allclose(tssm[:, slot].numpy(), jssm_[:, slot], **CACHE_TOL)


def _port_state(jstate):
    from repro_torch.models.convert import tensor_from_numpy
    from repro_torch.runtime import serve

    return serve.TieredKVState(**{
        f.name: tensor_from_numpy(np.asarray(getattr(jstate, f.name)))
        for f in dataclasses.fields(serve.TieredKVState)
    })


@pytest.mark.parametrize("route", ["fused", "per_pool"])
def test_hybrid_tiered_decode_step_matches_reference(lockstep, route):
    """One hybrid decode step from the same converted mid-run state (warm,
    cold and host pages, SSM side state), on both attention routes (the
    kernels' plain versions on the CPU), against the reference's step run
    eagerly (``jax.disable_jit``, so that it rounds to bf16 where PyTorch
    does). Logits, hotness and the new SSM state within 2e-4."""
    from repro.configs import ParallelConfig
    from repro.configs import TierScapeRunConfig as JRunConfig
    from repro.launch.mesh import make_mesh
    from repro.runtime import serve as jserve
    from repro_torch.configs import TierScapeRunConfig
    from repro_torch.kernels import ops
    from repro_torch.models.convert import tensor_from_numpy
    from repro_torch.runtime import serve

    ls = lockstep
    jstate, jside, tokens = ls["snapshot"]
    assert int(np.asarray(jstate.warm_n).sum()) > 0 and int(np.asarray(jstate.host_n).sum()) > 0
    jstep = jserve.make_tiered_decode_step(
        ls["jm"], make_mesh((1, 1), ("data", "model")), ParallelConfig(), JRunConfig(**RUN),
        use_kernels=False)
    with jax.disable_jit():
        jl, jtkv, (jconv, jsst), jtel = jstep(ls["jp"], jnp.asarray(tokens), jstate, jside)
    step = serve.make_tiered_decode_step(ls["tm"], TierScapeRunConfig(**RUN), device="cpu")
    side = tuple(tensor_from_numpy(np.asarray(a)) for a in jside)
    side_before = tuple(t.clone() for t in side)
    ops.use_fused(route == "fused")
    try:
        tl, ttkv, (tconv, tsst), ttel = step(ls["tp"], torch.as_tensor(tokens),
                                             _port_state(jstate), side)
    finally:
        ops.use_fused(True)
    assert all(torch.equal(a, b) for a, b in zip(side, side_before))  # input untouched
    assert tl.shape == (ENGINE["batch_slots"], 1, ls["cfg"].vocab_size)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **HOT_TOL)
    for k in ("warm", "cold", "host"):
        assert ttel[k].shape == np.asarray(jtel[k]).shape
        np.testing.assert_allclose(ttel[k].numpy(), np.asarray(jtel[k]), err_msg=k, **HOT_TOL)
    np.testing.assert_allclose(_f32(tconv), _f32(jconv), **HOT_TOL)
    np.testing.assert_allclose(tsst.numpy(), np.asarray(jsst), **HOT_TOL)
    np.testing.assert_array_equal(ttkv.recent_len.numpy(), np.asarray(jtkv.recent_len))
    np.testing.assert_allclose(_f32(ttkv.recent_k), _f32(jtkv.recent_k), **HOT_TOL)
