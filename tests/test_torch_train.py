"""``Model.loss`` and its backward in the port against
``jax.value_and_grad(model.loss)`` of the JAX package, on the CPU, for the
SMOKE config of every arch.

Weights come from ``repro.models.Model(cfg).init(jax.random.PRNGKey(0))``,
cast to f32 in the JAX package and carried across bit for bit
(``params_from_numpy``); the batch is the reference's ``make_train_batch``
(numpy seed 0; bf16 frame and patch embeddings). The loss must agree within
``LOSS_RTOL`` and every gradient leaf within ``GRAD_TOL`` of that leaf's
largest reference magnitude (measured: at most 7.7e-6 of it, zamba2's SSM
leaves; the dense archs 1.4e-6). The MoE archs run with the int8 wire on
and off; with it on, the gradient that reaches each wire's input must be
nonzero (``round`` alone has a zero gradient), and the wire's backward must
be the reference's custom VJP: the int8 round trip of the cotangent. The
MoE seeds keep ``tests/test_torch_moe.py``'s top-k margin check in f32.
One JAX gradient per case is computed once per module (``case``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.inputs import make_train_batch as jbatch  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime.train import value_and_grad  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # max |port - ref| over a leaf <= GRAD_TOL * max |ref| of that leaf
MARGIN_MIN = 1e-5  # tests/test_torch_moe.py: the smallest top-k margin in f32
MOE = ("qwen3_moe_235b", "dbrx_132b")
CASES = [(a, True) for a in ARCH_IDS] + [(a, False) for a in MOE]


def _f32_tree(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


@pytest.fixture(scope="module", params=CASES,
                ids=[a if a not in MOE else f"{a}-{'wire' if w else 'nowire'}"
                     for a, w in CASES])
def case(request):
    """Both packages' loss and gradients for one (arch, wire) case, the
    gradient maxima seen at the port's wire inputs, and the top-k margins
    of the port's dispatches."""
    arch, wire = request.param
    cfg = get_smoke(arch)
    jm = JModel(cfg)
    jp = _f32_tree(jm.init(jax.random.PRNGKey(0)))
    jb = jbatch(cfg, batch=2, seq=32)
    prev = (jmoe.A2A_WIRE_INT8, moe.A2A_WIRE_INT8, moe.make_wire_transfer, moe.route)
    wire_grads, margins = [], []

    def spy_wire():
        transfer = prev[2]()

        def f(x):
            if x.requires_grad:
                x.register_hook(lambda g: wire_grads.append(float(g.abs().max())))
            return transfer(x)
        return f

    def spy_route(p, c, x, capacity=None):
        plan = prev[3](p, c, x, capacity)
        k = c.moe.experts_per_token
        top = torch.sort(plan["probs"].detach(), dim=-1, descending=True).values
        margins.append(float((top[..., k - 1] - top[..., k]).min()))
        return plan

    jmoe.A2A_WIRE_INT8, moe.A2A_WIRE_INT8 = wire, wire
    moe.make_wire_transfer, moe.route = spy_wire, spy_route
    try:
        (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
        tm = Model(port_smoke(arch), device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        tb = params_from_numpy(jax.tree.map(np.asarray, jb))
        tl, tmetrics, tg = value_and_grad(tm, tp, tb)
    finally:
        jmoe.A2A_WIRE_INT8, moe.A2A_WIRE_INT8, moe.make_wire_transfer, moe.route = prev
    jleaves = [("/".join(str(k.key) for k in path), np.asarray(g))
               for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]]
    return dict(arch=arch, wire=wire, jl=float(jl), tl=float(tl), tmetrics=tmetrics,
                jleaves=jleaves, tleaves=pytree.leaves_with_path(tg), wire_grads=wire_grads,
                margins=margins, moe=cfg.family == "moe")


def test_loss_matches_reference(case):
    assert np.isfinite(case["tl"])
    assert case["tl"] == pytest.approx(case["jl"], rel=LOSS_RTOL)
    assert float(case["tmetrics"]["loss"]) == case["tl"]
    if case["moe"]:
        assert {"ce", "loss", "load_balance", "router_z"} <= set(case["tmetrics"])
        assert min(case["margins"]) > MARGIN_MIN, min(case["margins"])


def test_every_gradient_leaf_matches_reference(case):
    """Same leaves in JAX's order under the reference's paths, each within
    ``GRAD_TOL`` of its largest reference magnitude, in the params' dtype."""
    assert [k for k, _ in case["tleaves"]] == [k for k, _ in case["jleaves"]]
    for (key, t), (_, g) in zip(case["tleaves"], case["jleaves"]):
        assert t.dtype == torch.float32 and tuple(t.shape) == g.shape, key
        ref = float(np.abs(g).max())
        err = float(np.abs(t.numpy() - g).max())
        assert err <= GRAD_TOL * ref or err == ref == 0.0, (key, err, ref)


def test_gradient_reaches_the_experts_through_the_wire(case):
    """With the int8 wire on (MoE archs), each wire's input gets a nonzero,
    finite gradient (2 wires a layer); without a wire none is seen. The
    expert weights' gradients are nonzero either way."""
    n_wires = 2 * port_smoke(case["arch"]).n_layers if case["moe"] and case["wire"] else 0
    assert len(case["wire_grads"]) == n_wires
    assert all(np.isfinite(g) and g > 0 for g in case["wire_grads"]), case["wire_grads"]
    for key, t in case["tleaves"]:
        if key.startswith("blocks/moe/w_"):
            assert float(t.abs().max()) > 0, key


@pytest.mark.parametrize("seed", [2, 4, 5])
def test_wire_backward_is_the_reference_vjp(seed):
    """The wire's backward on a cotangent equals the reference's custom VJP
    (the int8 round trip of the cotangent), bit for bit in f32, and is not
    zero. Seeds 2, 4, 5: clear of half-code ties (ROADMAP §3)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 4, 3, 64)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    transfer = jmoe.make_wire_transfer(lambda a: a, lambda a: a)
    jy, vjp = jax.vjp(transfer, jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = moe.make_wire_transfer()(tx)
    (tgx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(jgx))
    assert float(tgx.abs().max()) > 0
    q, s = moe._wire_quant(torch.from_numpy(g))
    assert torch.equal(tgx, moe._wire_dequant(q, s, torch.float32))
