"""The MoE family (``qwen3_moe_235b``, ``dbrx_132b``) in the port against the
JAX package, on the CPU.

Weights come from ``repro.models.Model(cfg).init(jax.random.PRNGKey(0))``,
carried across bit for bit (``params_from_numpy``); inputs from numpy seeds.
``moe_ffn`` is held to the reference in f32 within ``OP_TOL``, with the int8
wire on and off, at a batch shape, a prefill shape whose capacity drops
tokens, the chunked path (``MOE_SEQ_CHUNK`` shrunk on both sides) and a
decode shape; its routing plan (top-k experts, capacity, valid slots) and
``dropped_frac`` must be equal, and aux within ``AUX_RTOL``. Routing is
discrete: the inputs' smallest top-k margin (the k-th probability less the
(k+1)-th) is checked to stand clear of f32 noise. Forward, prefill and greedy
decode logits are held to ``LOGIT_ATOL`` with equal greedy tokens, and the
``qwen3_moe_235b`` SMOKE engines run in lockstep at the settings of
``tests/test_torch_dense_archs.py::test_qwen3_engine_matches_reference``,
serially and async + prefetch at alpha 0.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.engine import TieredEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, TierScapeRunConfig  # noqa: E402
from repro_torch.configs import get as port_get  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402

ARCHS = ["qwen3_moe_235b", "dbrx_132b"]
LOGIT_ATOL = 0.0625  # four bf16 ulps at |logit| < 4 (test_torch_model.py)
OP_TOL = 2e-4
AUX_RTOL = 1e-6
MARGIN_MIN = 1e-5  # smallest top-k margin the op inputs must keep (f32 noise ~1e-7)
# The bf16 runs' smallest top-k margin: the two packages' bf16 activations
# differ by an ulp here and there (ROADMAP §3), which moves router
# probabilities by ~1e-4; prompt seed 1 meets margins of 1e-4 to 6e-4 and
# flips experts (ROADMAP §3).
MARGIN_BF16 = 5e-4
PARAM_KEY, PROMPT_SEED = 0, 0
# tests/test_system.py::test_engine_end_to_end
ENGINE = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
RUN = dict(enabled=True, policy="analytical", alpha=0.3, window_steps=6, faults=False)
NEW_TOKENS = 16
# (batch, seq, MOE_SEQ_CHUNK or None, input seed): one prompt as one group
# (the engine's prefill) with drops, two groups in three chunks with drops,
# and the tiered step's decode (a group of one token a slot). Input seed 3
# puts one f32 expert output of qwen3_moe_235b on a half-code boundary of the
# int8 wire (one code apart, ROADMAP §3).
SHAPES = {"prefill_drops": (1, 40, None, 2), "chunked": (2, 48, 16, 5),
          "decode": (2, 1, None, 4)}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    cfg = get_smoke(name)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(PARAM_KEY))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return name, cfg, jm, jp, Model(port_smoke(name), device="cpu"), tp


@pytest.fixture
def wire(request, monkeypatch):
    monkeypatch.setattr(jmoe, "A2A_WIRE_INT8", request.param)
    monkeypatch.setattr(moe, "A2A_WIRE_INT8", request.param)
    return request.param


@pytest.fixture
def margins(monkeypatch):
    """The smallest top-k margin (k-th less (k+1)-th router probability) of
    every port dispatch in the test."""
    seen = []
    route = moe.route

    def spy(p, cfg, x, capacity=None):
        plan = route(p, cfg, x, capacity)
        k = cfg.moe.experts_per_token
        top = torch.sort(plan["probs"], dim=-1, descending=True).values
        seen.append(float((top[..., k - 1] - top[..., k]).min()))
        return plan

    monkeypatch.setattr(moe, "route", spy)
    return seen


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _layer_f32(jp, layer=0):
    """One layer's MoE weights in f32, in both packages' trees."""
    jb = jax.tree.map(lambda a: a[layer].astype(jnp.float32), jp["blocks"]["moe"])
    return jb, params_from_numpy(jax.tree.map(np.asarray, jb))


_REFERENCE = {}


def _op_case(name, jp, shape, monkeypatch):
    """The f32 op case ``shape``: its input and the reference's output,
    computed once per (arch, shape, wire flag) and shared by the op and aux
    tests. The reference runs eagerly: jitted, XLA rounds ``dropped_frac``
    differently (-1.5e-8 for no drop)."""
    b, s, chunk, seed = SHAPES[shape]
    if chunk:
        monkeypatch.setattr(jmoe, "MOE_SEQ_CHUNK", chunk)
        monkeypatch.setattr(moe, "MOE_SEQ_CHUNK", chunk)
    jb, tb = _layer_f32(jp)
    x = np.random.default_rng(seed).normal(0, 1, (b, s, get_smoke(name).d_model))
    x = x.astype(np.float32)
    key = (name, shape, jmoe.A2A_WIRE_INT8)
    if key not in _REFERENCE:
        jy, jaux = jmoe.moe_ffn(jb, get_smoke(name), jnp.asarray(x))
        _REFERENCE[key] = np.asarray(jy), {k: float(v) for k, v in jaux.items()}
    return jb, tb, x, _REFERENCE[key]


def _jax_route(jb, cfg, x, capacity):
    """The reference's routing and dispatch (the first lines of
    ``repro.models.moe._moe_ffn_inner``), for the plan it does not return."""
    m = cfg.moe
    b, s, _ = x.shape
    e, k = m.n_experts, m.experts_per_token
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32), jb["router"]), -1)
    _, expert_ids = jax.lax.top_k(probs, k)
    ids_flat = expert_ids.reshape(b, s * k)
    counts = jax.vmap(lambda i: jnp.bincount(i, length=e))(ids_flat)
    slot_valid = jnp.arange(capacity)[None, None, :] < jnp.minimum(counts, capacity)[..., None]
    return np.asarray(probs), np.asarray(expert_ids), np.asarray(slot_valid)


def test_archs_are_registered_as_in_the_reference():
    """Both configs are the reference's, full and SMOKE, field for field."""
    for name in ARCHS:
        assert name in ARCH_IDS
        assert dataclasses.asdict(port_get(name)) == dataclasses.asdict(jget(name))
        assert dataclasses.asdict(port_smoke(name)) == dataclasses.asdict(get_smoke(name))
        assert port_get(name).family == "moe" and port_get(name).moe is not None


def test_params_carry_across_bit_for_bit(arch):
    """The converted tree equals the reference's leaf for leaf (the f32
    router included), and the port's own init builds the same tree: the same
    leaves, shapes and dtypes."""
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
    m = cfg.moe
    assert own["blocks"]["moe"]["router"].dtype == torch.float32
    assert own["blocks"]["moe"]["w_down"].shape == (cfg.n_layers, m.n_experts, m.d_ff_expert,
                                                    cfg.d_model)
    assert "ffn" not in own["blocks"]


@pytest.mark.parametrize("wire", [True, False], indirect=True, ids=["wire_int8", "wire_off"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_ffn_matches_reference_in_f32(arch, wire, shape, monkeypatch):
    """y within ``OP_TOL``; the routing plan and ``dropped_frac`` equal."""
    name, cfg, jm, jp, tm, tp = arch
    b, s, chunk, _ = SHAPES[shape]
    jb, tb, x, (jy, jaux) = _op_case(name, jp, shape, monkeypatch)
    ty, taux = moe.moe_ffn(tb, port_smoke(name), torch.from_numpy(x))
    assert ty.shape == (b, s, cfg.d_model) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), jy, rtol=OP_TOL, atol=OP_TOL)
    assert float(taux["dropped_frac"]) == jaux["dropped_frac"]
    # The plan, per dispatch call (one per chunk on the chunked path).
    span = chunk or s
    for c0 in range(0, s, span):
        xc = x[:, c0:c0 + span]
        plan = moe.route(tb, port_smoke(name), torch.from_numpy(xc))
        m = cfg.moe
        cap = max(int(span * m.experts_per_token * m.capacity_factor / m.n_experts), 1)
        assert plan["capacity"] == -(-cap // 4) * 4
        probs, ids, valid = _jax_route(jb, cfg, jnp.asarray(xc), plan["capacity"])
        np.testing.assert_array_equal(plan["expert_ids"].numpy(), ids)
        np.testing.assert_array_equal(plan["slot_valid"].numpy(), valid)
        np.testing.assert_allclose(plan["probs"].numpy(), probs, rtol=1e-6, atol=1e-7)
    if shape != "decode" and name == "qwen3_moe_235b":
        assert float(taux["dropped_frac"]) > 0  # capacity dropped tokens
    if shape == "decode":
        assert plan["capacity"] == 4 and float(taux["dropped_frac"]) == 0.0


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_aux_matches_reference(arch, shape, monkeypatch):
    """load_balance and router_z within ``AUX_RTOL`` (chunked: the mean over
    chunks), dropped_frac equal; the inputs' smallest top-k margin stands
    clear of f32 noise, so the discrete routing cannot flip."""
    name, cfg, jm, jp, tm, tp = arch
    jb, tb, x, (_, jaux) = _op_case(name, jp, shape, monkeypatch)
    _, taux = moe.moe_ffn(tb, port_smoke(name), torch.from_numpy(x))
    for key in ("load_balance", "router_z"):
        assert float(taux[key]) == pytest.approx(jaux[key], rel=AUX_RTOL), key
    assert float(taux["dropped_frac"]) == jaux["dropped_frac"]
    probs = np.sort(moe.route(tb, port_smoke(name), torch.from_numpy(x))["probs"].numpy(), -1)
    k = cfg.moe.experts_per_token
    margin = float((probs[..., -k] - probs[..., -k - 1]).min())
    assert margin > MARGIN_MIN, margin


def test_wire_quant_matches_reference():
    """The int8 wire codec: payload and scales equal, at round-half ties,
    zero rows and the clip."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3, 4, 6, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1, :4] = [127.0, 0.5, -0.5, 1.5]  # scale 1: exact half-integers
    x[0, 0, 1, 4:] = 0.25
    jq, js = jmoe._wire_quant(jnp.asarray(x))
    tq, ts = moe._wire_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and int(tq.abs().max()) == 127
    np.testing.assert_array_equal(
        moe._wire_dequant(tq, ts, torch.float32).numpy(),
        np.asarray(jmoe._wire_dequant(jq, js, jnp.float32)))
    y = torch.from_numpy(x).to(torch.bfloat16)
    assert moe.make_wire_transfer()(y).dtype == torch.bfloat16


def test_moe_ffn_is_deterministic_in_bf16(arch):
    """Two calls on the same bf16 inputs give byte-equal outputs (the
    combine is a gather, not an atomic scatter-add)."""
    name, cfg, jm, jp, tm, tp = arch
    blk = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 40, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    a, _ = moe.moe_ffn(blk, port_smoke(name), x)
    b, _ = moe.moe_ffn(blk, port_smoke(name), x)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_forward_matches_reference(arch, margins):
    """Logits within ``LOGIT_ATOL``; aux (summed over layers / n_layers)
    within 1e-3: in bf16 the router's inputs differ by the odd ulp."""
    name, cfg, jm, jp, tm, tp = arch
    tokens = np.random.default_rng(PROMPT_SEED).integers(1, cfg.vocab_size, (2, 32))
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, taux = tm.forward(tp, {"tokens": torch.as_tensor(tokens)})
    assert tl.shape == (2, 32, cfg.vocab_size) and tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
    assert set(taux) == set(jaux) == {"load_balance", "router_z"}
    for key in taux:
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-3), key
    assert min(margins) > MARGIN_BF16, min(margins)


def test_prefill_and_greedy_decode_match_reference(arch, margins):
    name, cfg, jm, jp, tm, tp = arch
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
    jstep = jax.jit(jm.decode_step)
    for _ in range(8):
        jl, jstate = jstep(jp, jnp.asarray([[jt[-1]]], jnp.int32), jstate)
        tl, tstate = tm.decode_step(tp, torch.as_tensor([[tt[-1]]]), tstate)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
        jt.append(int(jnp.argmax(jl[0, 0])))
        tt.append(int(torch.argmax(tl[0, 0])))
    assert tt == jt
    assert tstate.cache_len == int(jstate.cache_len) == 24 + 8
    assert min(margins) > MARGIN_BF16, min(margins)


# (async + prefetch, alpha, prompt seed)
MODES = {"serial": (False, 0.3, 0), "async_prefetch_alpha0": (True, 0.0, 0)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_qwen3_moe_engine_matches_reference(mode):
    """The qwen3_moe_235b SMOKE engines in lockstep: greedy tokens, physical
    and desired placements after every step, the stats counters,
    ``kernel_dispatches`` and TCO equal."""
    async_prefetch, alpha, prompt_seed = MODES[mode]
    cfg = get_smoke("qwen3_moe_235b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    run = dict(RUN, alpha=alpha, async_migration=async_prefetch, prefetch=async_prefetch)
    je = JEngine(jm, jp, ts=JRunConfig(**run), **ENGINE)
    te = TieredEngine(Model(port_smoke("qwen3_moe_235b"), device="cpu"), tp,
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
