"""The port's optimizers (``repro_torch.optim``): the reference's
``tests/test_optim.py`` run on the port, and op-level parity with the JAX
package on the same inputs (numpy seeds), on the CPU.

Tolerances: AdamW's update (params, m, v) within a relative 1e-6
(``UPDATE_RTOL``) of each value or, where a value nears 0, of its leaf's
largest; so are the clip norm, the clipped tree and the cosine schedule. Moment codes (µ-law int8/int4) equal except one-code flips where
a value sits on a half-code boundary and the two packages' f32 log1p/divide
round it apart: at most ``CODE_FLIPS`` of the codes, each one code off;
decoded values equal where the codes are, within one code step where they
are not. The gradient wire codec, its residual and ``wire_bytes`` are
exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim import tiered_adam as jtiered  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.optim import adamw, grad_compress, tiered_adam  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

UPDATE_RTOL = 1e-6
CODE_FLIPS = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _quad_problem(seed=0, dim=256):
    target = _t(np.random.default_rng(seed).normal(size=dim))
    params = {"w": torch.zeros(dim), "embed": torch.zeros(dim)}

    def loss(p):
        return torch.sum((p["w"] - target) ** 2) + torch.sum((p["embed"] - target) ** 2)

    return params, loss


def _grad(loss, params):
    req = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    gs = torch.autograd.grad(loss(req), list(req.values()))
    return dict(zip(req, gs))


def _clone(tree):
    return pytree.tree_map(lambda x: x.clone(), tree)


# --------------------------------------------------------------------------
# tests/test_optim.py on the port
# --------------------------------------------------------------------------


def test_adamw_descends():
    params, loss = _quad_problem()
    state = adamw.init(params)
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    l0 = float(loss(params))
    for _ in range(50):
        params, state, m = adamw.update(_grad(loss, params), state, params, cfg)
    assert float(loss(params)) < 0.2 * l0
    assert int(state["step"]) == 50


def test_adamw_grad_clip():
    grads = {"w": torch.full((8,), 1e6)}
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    assert float(adamw.global_norm(clipped)) <= 1.0 + 1e-5
    assert float(norm) > 1e5


def test_cosine_schedule_shape():
    fn = adamw.cosine_schedule(warmup=10, total=100)
    vals = [float(fn(torch.tensor(s))) for s in [0, 5, 10, 55, 100]]
    assert vals[0] == 0.0
    assert vals[1] == pytest.approx(0.5)
    assert vals[2] == pytest.approx(1.0)
    assert vals[2] > vals[3] > vals[4]
    assert vals[4] == pytest.approx(0.1, abs=1e-6)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_tiered_adam_tracks_adamw(codec):
    """Warm-tier moment codecs land near the f32 optimum under dense
    updates. (The updates consume their trees, so each run has its own.)"""
    params, loss = _quad_problem()
    policy = {"w": "none", "embed": codec}
    tp, fp = _clone(params), _clone(params)
    tstate = tiered_adam.init(tp, policy)
    fstate = adamw.init(fp)
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    for _ in range(60):
        tp, tstate, _ = tiered_adam.update(_grad(loss, tp), tstate, tp, cfg)
        fp, fstate, _ = adamw.update(_grad(loss, fp), fstate, fp, cfg)
    lf, lt = float(loss(fp)), float(loss(tp))
    assert lt < max(4 * lf, 1e-2), (codec, lt, lf)


def test_tiered_adam_int4_cold_leaves():
    params, loss = _quad_problem()
    policy = {"w": "none", "embed": "int4"}
    tstate = tiered_adam.init(params, policy)
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    tp = params
    l0 = float(loss(tp))
    for i in range(80):
        g = _grad(loss, tp)
        if i % 8 != 0:  # cold leaf: updates arrive rarely
            g = {"w": g["w"], "embed": torch.zeros_like(g["embed"])}
        tp, tstate, _ = tiered_adam.update(g, tstate, tp, cfg)
    assert float(loss(tp)) < 0.2 * l0


def test_tiered_adam_moment_bytes_saved():
    params = {"embed": torch.zeros((4096, 64)), "w": torch.zeros((128,))}
    b_f32 = tiered_adam.moment_bytes(tiered_adam.init(params, {"embed": "none", "w": "none"}))
    b_8 = tiered_adam.moment_bytes(tiered_adam.init(params, {"embed": "int8", "w": "none"}))
    b_4 = tiered_adam.moment_bytes(tiered_adam.init(params, {"embed": "int4", "w": "none"}))
    assert b_8 < 0.30 * b_f32
    assert b_4 < b_8
    # The formula: f32 m and v; int8 m and v with one f32 scale a row
    # (group_for(64) is 64); int4 packs m two codes a byte, v stays int8.
    assert tiered_adam.group_for(64) == 64
    assert b_f32 == 2 * 4 * (4096 * 64 + 128)
    assert b_8 == 2 * (4096 * 64 + 4096 * 4) + 2 * 4 * 128
    assert b_4 == (4096 * 32 + 4096 * 64) + 2 * 4096 * 4 + 2 * 4 * 128


def test_tiered_adam_repack_migration():
    params, loss = _quad_problem()
    state = tiered_adam.init(params, {"w": "none", "embed": "none"})
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    p = params
    for _ in range(10):
        p, state, _ = tiered_adam.update(_grad(loss, p), state, p, cfg)
    state2 = tiered_adam.repack(state, p, {"w": "none", "embed": "int8"})
    assert dict(state2.policy)["embed"] == "int8"
    # embed is the first leaf in JAX's (sorted) order.
    m_old = tiered_adam.decode_moment(pytree.leaves(state.m)[0],
                                      pytree.leaves(state.m_scales)[0], "none", (256,))
    m_new = tiered_adam.decode_moment(pytree.leaves(state2.m)[0],
                                      pytree.leaves(state2.m_scales)[0], "int8", (256,))
    rel = float(torch.linalg.norm(m_old - m_new) / (torch.linalg.norm(m_old) + 1e-9))
    assert rel < 0.02


def test_grad_compress_roundtrip_error_feedback():
    x = _t(np.random.default_rng(0).normal(0, 1, (1000,)))
    xq, resid = grad_compress.compress_roundtrip(x)
    np.testing.assert_allclose((xq + resid).numpy(), x.numpy(), rtol=1e-6)
    assert float(torch.linalg.norm(x - xq) / torch.linalg.norm(x)) < 0.01


def test_grad_compress_sgd_converges():
    target = _t(np.random.default_rng(0).normal(size=512))
    w_c, w_u, resid = torch.zeros(512), torch.zeros(512), torch.zeros(512)
    lr = 0.2
    for _ in range(80):
        gq, resid = grad_compress.compress_roundtrip(2 * (w_c - target) + resid)
        w_c = w_c - lr * gq
        w_u = w_u - lr * 2 * (w_u - target)
    assert float(torch.linalg.norm(w_c - target)) < 1e-2
    assert float(torch.linalg.norm(w_c - w_u)) < 0.05


def test_grad_compress_wire_bytes():
    raw, comp = grad_compress.wire_bytes({"w": torch.zeros((1024, 1024))})
    assert comp < 0.3 * raw


# --------------------------------------------------------------------------
# op-level parity with the JAX package
# --------------------------------------------------------------------------

SHAPES = {"a": (64, 48), "b": (5,), "c": [(3, 130), (200,)]}


def _random_tree(rng, positive=False, scale=1.0):
    def leaf(shape):
        x = rng.normal(0, scale, shape).astype(np.float32)
        return np.abs(x) if positive else x

    return {"a": leaf(SHAPES["a"]), "b": leaf(SHAPES["b"]),
            "c": [leaf(SHAPES["c"][0]), leaf(SHAPES["c"][1])]}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_tree(tree):
    return params_from_numpy(tree)


def _assert_tree_close(ttree, jtree, rtol):
    """Each leaf within ``rtol`` of its values, and of its largest value
    where a value is near 0 (m's ``b1 m + (1 - b1) g`` cancels there)."""
    tl, jl = pytree.leaves_with_path(ttree), jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(tl) == len(jl)
    for (key, t), (_, j) in zip(tl, jl):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.float().numpy(), j, rtol=rtol,
                                   atol=rtol * float(np.abs(j).max()), err_msg=key)


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    """One update from a mid-run state (step 3, cosine schedule, weight
    decay), with the gradient norm under and over the clip."""
    rng = np.random.default_rng(7)
    p, g = _random_tree(rng), _random_tree(rng, scale=grad_scale)
    m, v = _random_tree(rng, scale=1e-2), _random_tree(rng, positive=True, scale=1e-3)
    kw = dict(lr=1e-3, weight_decay=0.1, grad_clip_norm=1.0)
    jcfg = jadamw.AdamWConfig(schedule=jadamw.cosine_schedule(2, 50), **kw)
    tcfg = AdamWConfig(schedule=adamw.cosine_schedule(2, 50), **kw)
    jstate = {"m": _jax_tree(m), "v": _jax_tree(v), "step": jnp.asarray(3, jnp.int32)}
    tstate = {"m": _torch_tree(m), "v": _torch_tree(v), "step": torch.tensor(3, dtype=torch.int32)}
    jp, js, jm = jadamw.update(_jax_tree(g), jstate, _jax_tree(p), jcfg)
    tp, ts, tm = adamw.update(_torch_tree(g), tstate, _torch_tree(p), tcfg)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=UPDATE_RTOL)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=UPDATE_RTOL)
    assert int(ts["step"]) == 4 and ts["step"].dtype == torch.int32
    _assert_tree_close(tp, jp, UPDATE_RTOL)
    _assert_tree_close(ts["m"], js["m"], UPDATE_RTOL)
    _assert_tree_close(ts["v"], js["v"], UPDATE_RTOL)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    g = _random_tree(rng, scale=5.0)
    jc, jn = jadamw.clip_by_global_norm(_jax_tree(g), 1.0)
    tc, tn = adamw.clip_by_global_norm(_torch_tree(g), 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=UPDATE_RTOL)
    _assert_tree_close(tc, jc, UPDATE_RTOL)
    assert float(adamw.global_norm(tc)) == pytest.approx(1.0, rel=1e-6)


def test_cosine_schedule_matches_reference():
    jfn, tfn = jadamw.cosine_schedule(10, 100), adamw.cosine_schedule(10, 100)
    steps = np.arange(0, 131, dtype=np.int32)
    want = np.array([float(jfn(jnp.asarray(s))) for s in steps])
    got = np.array([float(tfn(torch.tensor(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=UPDATE_RTOL, atol=1e-7)


def test_group_for_matches_reference():
    assert [tiered_adam.group_for(n) for n in range(1, 8193)] == \
        [jtiered.group_for(n) for n in range(1, 8193)]


def _codes(payload, codec):
    """Signed integer codes of a payload (int4 unpacked, even index low)."""
    p = np.asarray(payload)
    if codec == "int8":
        return p.astype(np.int32)
    p = p.astype(np.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    q = np.stack([lo, hi], -1).reshape(*p.shape[:-1], -1)
    return np.where(q >= 8, q - 16, q)


def _code_step(codec, scales):
    """The largest distance between two adjacent decoded codes, per group."""
    mu, qmax = tiered_adam.MU[codec], tiered_adam.QMAX[codec]
    top = [float(jtiered._mulaw_dec(jnp.float32(c), mu, qmax)) for c in (qmax, qmax - 1)]
    return (top[0] - top[1]) * np.asarray(scales)


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("shape", [(64, 300), (7,), (), (3, 5, 256), (40, 2560)])
def test_moment_codec_matches_reference(codec, shape):
    x = np.random.default_rng(11).normal(0, 1e-3, shape).astype(np.float32)
    jpay, jsc = jtiered.encode_moment(jnp.asarray(x), codec)
    tpay, tsc = tiered_adam.encode_moment(torch.from_numpy(x), codec)
    assert tpay.dtype == {"int8": torch.int8, "int4": torch.uint8}[codec]
    assert tuple(tpay.shape) == jpay.shape and tuple(tsc.shape) == jsc.shape
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))  # absmax: exact
    jq, tq = _codes(jpay, codec), _codes(tpay.numpy(), codec)
    diff = np.abs(jq - tq)
    assert diff.max(initial=0) <= 1 and (diff > 0).mean() <= CODE_FLIPS, int((diff > 0).sum())
    jx = np.asarray(jtiered.decode_moment(jpay, jsc, codec, shape))
    tx = tiered_adam.decode_moment(tpay, tsc, codec, shape).numpy()
    assert tx.shape == shape
    # The same payload decodes alike in both packages.
    np.testing.assert_allclose(
        tiered_adam.decode_moment(tensor_from_numpy(jpay), tensor_from_numpy(jsc), codec,
                                  shape).numpy(), jx, rtol=1e-6, atol=1e-12)
    step = np.repeat(_code_step(codec, tsc.numpy()), tiered_adam.group_for(
        shape[-1] if shape else 1), axis=-1)[..., :shape[-1] if shape else 1].reshape(shape)
    assert (np.abs(tx - jx) <= step * (1 + 1e-5) + 1e-12).all()


@pytest.mark.parametrize("old, new", [("none", "int8"), ("int8", "int4"), ("int4", "bf16"),
                                      ("bf16", "none")])
def test_repack_matches_reference(old, new):
    """repack from the same state (the JAX package's, carried across bit for
    bit) under the same new policy."""
    rng = np.random.default_rng(5)
    p = {"embed": rng.normal(0, 1, (32, 96)).astype(np.float32),
         "w": rng.normal(0, 1, (130,)).astype(np.float32)}
    m, v = {k: x * 1e-2 for k, x in p.items()}, {k: np.abs(x) * 1e-4 for k, x in p.items()}
    jp = _jax_tree(p)
    old_pol, new_pol = {"embed": old, "w": "none"}, {"embed": new, "w": old}
    js = jtiered.init(jp, old_pol)
    enc = {k: jtiered.encode_moment(jnp.asarray(m[k]), old_pol[k]) for k in p}
    enc_v = {k: jtiered.encode_moment(jnp.asarray(v[k]), "int8" if c == "int4" else c)
             for k, c in old_pol.items()}
    js = jtiered.TieredAdamState(m={k: e[0] for k, e in enc.items()},
                                 m_scales={k: e[1] for k, e in enc.items()},
                                 v={k: e[0] for k, e in enc_v.items()},
                                 v_scales={k: e[1] for k, e in enc_v.items()},
                                 step=js.step, policy=js.policy)
    ts = tiered_adam.TieredAdamState(
        *[params_from_numpy(jax.tree.map(np.asarray, getattr(js, f)))
          for f in ("m", "m_scales", "v", "v_scales")],
        step=torch.tensor(0, dtype=torch.int32), policy=js.policy)
    j2 = jtiered.repack(js, jp, new_pol)
    t2 = tiered_adam.repack(ts, _torch_tree(p), new_pol)
    assert t2.policy == j2.policy
    for f in ("m", "m_scales", "v", "v_scales"):
        for (_, j), (key, t) in zip(jax.tree_util.tree_flatten_with_path(getattr(j2, f))[0],
                                    pytree.leaves_with_path(getattr(t2, f))):
            _assert_moment_leaf(t, np.asarray(j), 1e-6, f"{f} {key}")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _assert_moment_leaf(t: torch.Tensor, j: np.ndarray, rtol: float, what: str):
    """Same dtype and shape; codes one apart on at most ``CODE_FLIPS`` of
    them, float leaves within ``rtol``."""
    assert _dtype_name(t) == str(j.dtype) and tuple(t.shape) == j.shape, what
    if j.dtype in (np.int8, np.uint8):
        codec = "int4" if j.dtype == np.uint8 else "int8"
        diff = np.abs(_codes(j, codec) - _codes(t.numpy(), codec))
        assert diff.max(initial=0) <= 1 and (diff > 0).mean() <= CODE_FLIPS, what
    else:
        np.testing.assert_allclose(t.float().numpy(), j.astype(np.float32), rtol=rtol,
                                   atol=1e-12, err_msg=what)


def test_tiered_update_matches_reference():
    """One tiered update over a policy with every codec."""
    rng = np.random.default_rng(9)
    p = {"embed": rng.normal(0, 1, (16, 64)).astype(np.float32),
         "lm_head": rng.normal(0, 1, (64, 40)).astype(np.float32),
         "w": rng.normal(0, 1, (130,)).astype(np.float32),
         "x": rng.normal(0, 1, (8, 32)).astype(np.float32)}
    g = {k: rng.normal(0, 0.1, x.shape).astype(np.float32) for k, x in p.items()}
    policy = {"embed": "int8", "lm_head": "int4", "w": "none", "x": "bf16"}
    cfg = dict(lr=1e-3)
    jupdate = jax.jit(jtiered.update, static_argnums=3)
    jp, js, jm = jupdate(_jax_tree(g), jtiered.init(_jax_tree(p), policy), _jax_tree(p),
                         jadamw.AdamWConfig(**cfg))
    tp, ts, tm = tiered_adam.update(_torch_tree(g), tiered_adam.init(_torch_tree(p), policy),
                                    _torch_tree(p), AdamWConfig(**cfg))
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=UPDATE_RTOL)
    _assert_tree_close(tp, jp, UPDATE_RTOL)
    assert ts.policy == js.policy and int(ts.step) == 1
    for f in ("m", "m_scales", "v", "v_scales"):
        for (_, j), (key, t) in zip(jax.tree_util.tree_flatten_with_path(getattr(js, f))[0],
                                    pytree.leaves_with_path(getattr(ts, f))):
            _assert_moment_leaf(t, np.asarray(j), UPDATE_RTOL, f"{f} {key}")


@pytest.mark.parametrize("shape, dtype", [((1000,), np.float32), ((37, 300), np.float32),
                                          ((4, 256), np.float32), ((513,), "bfloat16")])
def test_compress_roundtrip_matches_reference(shape, dtype):
    x = np.random.default_rng(13).normal(0, 1, shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = tensor_from_numpy(np.asarray(jx))
    jq, jr = jgc.compress_roundtrip(jx)
    tq, tr = grad_compress.compress_roundtrip(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    q, s = grad_compress._enc(tx)
    jqq, js_ = jgc._enc(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))


def test_compressed_psum_tree_matches_reference():
    """On one participant the reference's psum over "pod" (a vmap of size
    1 here) is the identity; the port's sum and residual are its."""
    rng = np.random.default_rng(17)
    g, r = _random_tree(rng), _random_tree(rng, scale=1e-3)

    def ref(g, r):
        return jgc.compressed_psum_tree(g, r, "pod")

    lead = jax.tree.map(lambda a: jnp.asarray(a)[None], (g, r))
    js, jr = jax.vmap(ref, axis_name="pod")(*lead)
    ts, tr = grad_compress.compressed_psum_tree(_torch_tree(g), _torch_tree(r), "pod")
    for t, j in zip(pytree.leaves(ts) + pytree.leaves(tr),
                    jax.tree.leaves(js) + jax.tree.leaves(jr)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[0])
    # Without a residual (the first step).
    js0, jr0 = jax.vmap(lambda g: jgc.compressed_psum_tree(g, None, "pod"),
                        axis_name="pod")(lead[0])
    ts0, tr0 = grad_compress.compressed_psum_tree(_torch_tree(g), None, "pod")
    for t, j in zip(pytree.leaves(ts0) + pytree.leaves(tr0),
                    jax.tree.leaves(js0) + jax.tree.leaves(jr0)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[0])


def _reference_shapes(arch):
    """The JAX package's SMOKE params as shapes (``jax.eval_shape``) and the
    port's own init of the same config."""
    jp = jax.eval_shape(JModel(get_smoke(arch)).init, jax.random.PRNGKey(0))
    return jp, Model(port_smoke(arch), device="cpu").init(0)


def test_wire_bytes_and_init_residual_match_reference():
    jp, tp = _reference_shapes("qwen3_moe_235b")
    assert grad_compress.wire_bytes(tp) == jgc.wire_bytes(jp)
    res = grad_compress.init_residual(tp)
    assert all(r.dtype == torch.float32 and r.shape == p.shape and not r.any()
               for r, p in zip(pytree.leaves(res), pytree.leaves(tp)))


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "zamba2_1_2b", "qwen3_moe_235b"])
def test_default_policy_and_moment_bytes_match_reference(arch):
    """The policy's keys are the reference's path strings; the tiered state
    has the reference's leaves, shapes and dtypes, so ``moment_bytes``
    agrees."""
    jp, tp = _reference_shapes(arch)
    for codec in ("int8", "int4"):
        policy = tiered_adam.default_policy(tp, codec)
        assert policy == jtiered.default_policy(jp, codec)
        js = jax.eval_shape(lambda p: jtiered.init(p, policy), jp)
        ts = tiered_adam.init(tp, policy)
        assert tiered_adam.moment_bytes(ts) == jtiered.moment_bytes(js)
        for f in ("m", "m_scales", "v", "v_scales"):
            assert [(tuple(t.shape), _dtype_name(t)) for t in pytree.leaves(getattr(ts, f))] \
                == [(a.shape, str(a.dtype)) for a in jax.tree.leaves(getattr(js, f))]
