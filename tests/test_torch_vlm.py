"""The Qwen2-VL backbone (``qwen2_vl_72b``: QKV biases, M-RoPE, patch
embeddings) in the port against the JAX package, on the CPU.

Weights come from ``repro.models.Model(cfg).init(jax.random.PRNGKey(0))``,
carried across bit for bit; inputs from numpy seeds (``make_train_batch``
makes the same batch in both packages). ``apply_mrope`` is held to the
reference on [3, B, S] positions whose t/h/w ids differ; ``forward`` on a
vision batch, prefill and greedy decode on text to ``LOGIT_ATOL``; the SMOKE
engines run in lockstep on prompts of equal length. One test shows the
reference's M-RoPE fault in its tiered decode step (per-slot positions
[B, 1] read as [3, B, S], so slots of unequal length mix their rotations)
and that the port's step rotates each slot at its own position.
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

NAME = "qwen2_vl_72b"
LOGIT_ATOL = 0.0625  # four bf16 ulps at |logit| < 4 (test_torch_model.py)
OP_TOL = 2e-4
PARAM_KEY, PROMPT_SEED, BATCH_SEED = 0, 1, 2
# tests/test_system.py::test_engine_end_to_end
ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
RUN = dict(enabled=True, policy="analytical", alpha=0.3, window_steps=6, faults=False)
NEW_TOKENS = 16
UNEQUAL = (40, 27)  # prompt lengths of the M-RoPE fault test


@pytest.fixture(scope="module")
def vlm():
    cfg = get_smoke(NAME)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    # Non-zero QKV biases in both trees (the reference inits them to zeros).
    rng = np.random.default_rng(11)
    for name in ("bq", "bk", "bv"):
        w = rng.normal(0, 0.1, jp["blocks"]["attn"][name].shape).astype(np.float32)
        jp["blocks"]["attn"][name] = jnp.asarray(w, jnp.bfloat16)
        tp["blocks"]["attn"][name] = torch.from_numpy(w).to(torch.bfloat16)
    return cfg, jm, jp, Model(port_smoke(NAME), device="cpu"), tp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _layer_f32(jp, tp, layer=1):
    jl = {k: jnp.asarray(v[layer], jnp.float32) for k, v in jp["blocks"]["attn"].items()}
    tl = {k: v[layer].float() for k, v in tp["blocks"]["attn"].items()}
    return jl, tl


def test_arch_is_registered_as_in_the_reference():
    assert NAME in ARCH_IDS
    assert dataclasses.asdict(port_get(NAME)) == dataclasses.asdict(jget(NAME))
    assert dataclasses.asdict(port_smoke(NAME)) == dataclasses.asdict(get_smoke(NAME))
    cfg = port_get(NAME)
    assert cfg.mrope and cfg.qkv_bias and cfg.frontend == "vision"
    assert sum(cfg.mrope_sections) == cfg.head_dim_() // 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(dtype):
    """[3, B, S] positions with distinct t/h/w ids (a patch grid after a
    few text tokens), in f32 and bf16."""
    cfg = port_smoke(NAME)
    rng = np.random.default_rng(3)
    b, s, h, hd = 2, 12, 4, cfg.head_dim_()
    x = rng.normal(0, 1, (b, s, h, hd)).astype(np.float32)
    pos = np.stack([np.broadcast_to(np.arange(s), (b, s)),
                    rng.integers(0, 40, (b, s)), rng.integers(0, 40, (b, s))]).astype(np.int32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jlayers.apply_mrope(jx, jnp.asarray(pos), cfg.rope_theta, cfg.mrope_sections)
    got = layers.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(pos), cfg.rope_theta, cfg.mrope_sections)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    tol = OP_TOL if dtype == "float32" else 1 / 64
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # Text positions (equal on the three axes) are 1-D RoPE.
    text = np.broadcast_to(pos[0], (3, b, s))
    np.testing.assert_allclose(
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(text.copy()), cfg.rope_theta,
                           cfg.mrope_sections).numpy(),
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), cfg.rope_theta).numpy(),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="3, B, S"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos[0]), cfg.rope_theta,
                           cfg.mrope_sections)


@pytest.mark.parametrize("arch", ["qwen2_vl_72b", "hubert_xlarge", "qwen3_moe_235b"])
def test_batches_equal_reference(arch):
    """``train_batch_spec``/``decode_token_spec`` name the reference's fields,
    shapes and dtypes; ``make_train_batch`` makes the reference's batch from
    the same seed (bf16 embeddings bit for bit)."""
    cfg = port_smoke(arch)
    jspec = jinputs.train_batch_spec(get_smoke(arch), 2, 16)
    spec = inputs.train_batch_spec(cfg, 2, 16)
    assert set(spec) == set(jspec)
    for k, (shape, dtype) in spec.items():
        assert shape == jspec[k].shape and str(dtype).split(".")[-1] == str(jspec[k].dtype), k
    assert inputs.decode_token_spec(cfg, 3) == ((3, 1), torch.int32)
    jb = jinputs.make_train_batch(get_smoke(arch), 2, 16, seed=BATCH_SEED)
    tb = inputs.make_train_batch(cfg, 2, 16, seed=BATCH_SEED, device="cpu")
    assert set(tb) == set(jb)
    for k in tb:
        assert tuple(tb[k].shape) == jb[k].shape, k
        np.testing.assert_array_equal(_f32(tb[k]), _f32(jb[k]), err_msg=k)
        assert str(tb[k].dtype).split(".")[-1] == str(jb[k].dtype), k


def test_project_qkv_matches_reference(vlm):
    """q, k, v (biases, M-RoPE on [3, B, S] positions) in f32, to 2e-4."""
    cfg, jm, jp, tm, tp = vlm
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 7, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 20, (3, 2, 7)).astype(np.int32)
    jl, tl = _layer_f32(jp, tp)
    want = jattn._project_qkv(jl, cfg, jnp.asarray(x), jnp.asarray(pos),
                              jattn.ActivationSharding())
    got = attention._project_qkv(tl, port_smoke(NAME), torch.from_numpy(x), torch.from_numpy(pos))
    for what, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OP_TOL, atol=OP_TOL,
                                   err_msg=what)


def test_forward_on_a_vision_batch_matches_reference(vlm):
    """Patch embeddings replace the first seq/8 token embeddings; 3-axis
    positions. Logits within ``LOGIT_ATOL``; the patches change them."""
    cfg, jm, jp, tm, tp = vlm
    jb = jinputs.make_train_batch(cfg, 2, 32, seed=BATCH_SEED)
    tb = inputs.make_train_batch(port_smoke(NAME), 2, 32, seed=BATCH_SEED, device="cpu")
    jl, jaux = jm.forward(jp, jb)
    tl, taux = tm.forward(tp, tb)
    assert tl.shape == (2, 32, cfg.vocab_size) and tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
    assert float(taux["load_balance"]) == float(jaux["load_balance"]) == 0.0
    text = {k: v for k, v in tb.items() if k not in ("embeds", "embeds_mask")}
    assert float((tm.forward(tp, text)[0].float() - tl.float()).abs().max()) > 0.1


def test_prefill_and_greedy_decode_match_reference(vlm):
    cfg, jm, jp, tm, tp = vlm
    prompt = np.random.default_rng(PROMPT_SEED).integers(1, cfg.vocab_size, 24)
    jstate = jm.init_cache(1, 64)
    jl, jstate = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None], jnp.int32)}, jstate)
    tstate = tm.init_cache(1, 64)
    tl, tstate = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])}, tstate)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(_f32(tstate.k_cache), _f32(jstate.k_cache), atol=LOGIT_ATOL)
    jt = [int(jnp.argmax(jl[0, -1]))]
    tt = [int(torch.argmax(tl[0, -1]))]
    jstep = jax.jit(jm.decode_step)
    for _ in range(8):
        jl, jstate = jstep(jp, jnp.asarray([[jt[-1]]], jnp.int32), jstate)
        tl, tstate = tm.decode_step(tp, torch.as_tensor([[tt[-1]]]), tstate)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
        jt.append(int(jnp.argmax(jl[0, 0])))
        tt.append(int(torch.argmax(tl[0, 0])))
    assert tt == jt


MODES = {"serial": (False, 0.3), "async_prefetch_alpha0": (True, 0.0)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_vlm_engine_matches_reference_on_equal_prompts(vlm, mode):
    """The SMOKE engines in lockstep on two text prompts of equal length
    (where the reference's tiered M-RoPE is right): tokens, physical and
    desired placements after every step, the counters and TCO equal."""
    cfg, jm, jp, tm, tp = vlm
    async_prefetch, alpha = MODES[mode]
    run = dict(RUN, alpha=alpha, async_migration=async_prefetch, prefetch=async_prefetch)
    je = JEngine(jm, jp, ts=JRunConfig(**run), **ENGINE)
    te = TieredEngine(tm, tp, ts=TierScapeRunConfig(**run), device="cpu", **ENGINE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 24) for _ in range(2)]
    jreqs = [je.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
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
    js, ts = je.finish(), te.finish()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == NEW_TOKENS for r in treqs) and ts.completed == 2
    for f in ("steps", "windows", "migrations", "overlapped_steps", "prefetch_staged",
              "prefetch_hits", "prefetch_misses", "attn_launches"):
        assert getattr(ts, f) == getattr(js, f), f
    assert te.cache.kernel_dispatches == je.cache.kernel_dispatches
    assert ts.tco_savings_pct == pytest.approx(js.tco_savings_pct, rel=1e-12)
    if alpha == 0.0:
        assert ts.migrations > 0 and ts.overlapped_steps > 0


def _one_step_logits(tm, tp, prompts, slots):
    """Prefill ``prompts`` into a fresh port engine of ``slots`` slots and
    take one tiered decode step on its state: logits [B, V]."""
    eng = TieredEngine(tm, tp, batch_slots=slots, ts=TierScapeRunConfig(**RUN), device="cpu",
                       **{k: v for k, v in ENGINE.items() if k != "batch_slots"})
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    eng._fill_slots()
    assert eng.cache.state.total_len.tolist() == [len(p) for p in prompts]
    step = serve.make_tiered_decode_step(tm, eng.ts, device="cpu")
    tokens = torch.as_tensor([[r.out_tokens[-1]] for r in eng.slots])
    logits, _, _, _ = step(tp, tokens, eng.cache.state, eng.ssm_state)
    return logits[:, 0]


def test_reference_mrope_mixes_slots_and_the_port_does_not(vlm):
    """The reference's tiered step passes per-slot positions [B, 1] to
    ``_project_qkv``; under M-RoPE ``apply_mrope`` reads them as [3, B, S], so
    slot i's position drives section i. (a) At unequal lengths that differs
    from the reference's own result on [3, B, 1] positions. (b) The port's
    step positions give the reference's [3, B, 1] q/k, which are 1-D RoPE at
    each slot's own position. (c) Each slot's logits from a 2-slot port step
    at unequal lengths equal that slot's 1-slot step."""
    cfg, jm, jp, tm, tp = vlm
    x = np.random.default_rng(5).normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    total = np.array(UNEQUAL, np.int32)
    jl, tl = _layer_f32(jp, tp)
    shard = jattn.ActivationSharding()
    mixed = jattn._project_qkv(jl, cfg, jnp.asarray(x), jnp.asarray(total[:, None]), shard)
    per_slot = jattn._project_qkv(jl, cfg, jnp.asarray(x),
                                  jnp.asarray(np.broadcast_to(total[None, :, None], (3, 2, 1))),
                                  shard)
    assert float(jnp.abs(mixed[0] - per_slot[0]).max()) > 0.1  # (a) q
    assert float(jnp.abs(mixed[1] - per_slot[1]).max()) > 0.1  # (a) k
    pos = serve.step_positions(port_smoke(NAME), torch.from_numpy(total))
    assert tuple(pos.shape) == (3, 2, 1)
    got = attention._project_qkv(tl, port_smoke(NAME), torch.from_numpy(x), pos)
    rope = jattn._project_qkv(jl, dataclasses.replace(cfg, mrope=False), jnp.asarray(x),
                              jnp.asarray(total[:, None]), shard)
    for g, w, r in zip(got, per_slot, rope):  # (b)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OP_TOL, atol=OP_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=OP_TOL, atol=OP_TOL)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in UNEQUAL]
    both = _one_step_logits(tm, tp, prompts, 2)
    for i, p in enumerate(prompts):  # (c)
        alone = _one_step_logits(tm, tp, [p], 1)
        np.testing.assert_allclose(_f32(both[i]), _f32(alone[0]), atol=1 / 64, rtol=0)
