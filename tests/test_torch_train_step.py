"""The port's train step (``runtime/train.make_train_step``) against the JAX
package's on the CPU, and ``tests/test_archs.py::test_smoke_train_step`` on
the port.

Two f32 steps of the SMOKE ``qwen1_5_4b`` with AdamW and with tiered Adam
under ``default_policy`` (int8 moments on ``embed``/``lm_head``), and with
``grad_accum=2`` on ``command_r_35b`` and on ``qwen2_vl_72b`` (whose [3, B,
S] M-RoPE positions split on axis 1), from the reference's weights and
batch: losses and grad norms within ``METRIC_RTOL``, parameters within
``PARAM_ATOL`` after each step (lr 1e-3, so two steps move a weight by at
most ~2e-3; measured 1.9e-5 for AdamW and 4.5e-5 for tiered Adam, where an
int8 moment code one step off on a half-code boundary moves its weight's
update), f32 moments within ``MOMENT_RTOL`` of each leaf's largest, int8
codes at most one code apart on at most ``CODE_FLIPS`` of them. The
``ParallelConfig`` fields that do nothing on one device change nothing, and
remat changes no number.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.configs.base import ParallelConfig as JParallelConfig  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.inputs import make_train_batch as jbatch  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import tiered_adam as jtiered  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import ARCH_IDS, ParallelConfig  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.inputs import make_train_batch  # noqa: E402
from repro_torch.optim import adamw, tiered_adam  # noqa: E402
from repro_torch.runtime.train import make_train_step, value_and_grad  # noqa: E402

METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-4
MOMENT_RTOL = 1e-5
CODE_FLIPS = 1e-3
LR = 1e-3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """tests/test_archs.py::test_smoke_train_step on the port: bf16 weights,
    two AdamW steps on one batch descend."""
    cfg = port_smoke(arch)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    opt = adamw.init(params)
    batch = make_train_batch(cfg, batch=2, seq=32, device="cpu")

    def step(params, opt, batch):
        loss, _, grads = value_and_grad(model, params, batch)
        params, opt, _ = adamw.update(grads, opt, params, adamw.AdamWConfig(lr=LR))
        return params, opt, loss

    p1, o1, loss1 = step(params, opt, batch)
    p2, o2, loss2 = step(p1, o1, batch)
    assert p2["embed"].dtype == torch.bfloat16
    assert bool(torch.isfinite(loss1)) and bool(torch.isfinite(loss2))
    assert float(loss2) < float(loss1), "two steps on the same batch must descend"
    assert int(o2["step"]) == 2 and o2["step"].dtype == torch.int32


STEP_CASES = [("qwen1_5_4b", "adamw", 1, 2, 32), ("qwen1_5_4b", "tiered", 1, 2, 32),
              ("command_r_35b", "adamw", 2, 4, 16), ("qwen2_vl_72b", "adamw", 2, 2, 32)]


def _compare_params(jtree, ttree, what):
    for (path, a), (key, t) in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                                   pytree.leaves_with_path(ttree)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {key}")


def _compare_tiered(jstate, tstate, what):
    assert tstate.policy == jstate.policy
    assert int(tstate.step) == int(jstate.step)
    for f in ("m", "m_scales", "v", "v_scales"):
        for (_, a), (key, t) in zip(jax.tree_util.tree_flatten_with_path(getattr(jstate, f))[0],
                                    pytree.leaves_with_path(getattr(tstate, f))):
            a, t = np.asarray(a), t.numpy()
            assert a.dtype == t.dtype and a.shape == t.shape, (what, f, key)
            if a.dtype == np.int8:
                diff = np.abs(a.astype(np.int32) - t.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FLIPS, (what, f, key)
            elif a.size:
                scale = max(float(np.abs(a).max()), 1e-30)
                assert float(np.abs(a - t).max()) <= MOMENT_RTOL * scale, (what, f, key)


@pytest.mark.parametrize("arch, opt, accum, bsz, seq", STEP_CASES,
                         ids=[f"{a}-{o}-accum{n}" for a, o, n, _, _ in STEP_CASES])
def test_train_step_matches_reference(arch, opt, accum, bsz, seq):
    cfg = get_smoke(arch)
    jm = JModel(cfg, JParallelConfig())
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jm.init(jax.random.PRNGKey(0)))
    jb = jbatch(cfg, batch=bsz, seq=seq)
    mesh = make_mesh((1, 1), ("data", "model"))
    jpolicy = jtiered.default_policy(jp) if opt == "tiered" else None
    jstep = jtrain.make_train_step(jm, jadamw.AdamWConfig(lr=LR), mesh,
                                   JParallelConfig(grad_accum=accum), batch_example=jb,
                                   tiered_policy=jpolicy)
    jo = jtiered.init(jp, jpolicy) if jpolicy else jadamw.init(jp)
    with mesh:
        fn = jstep.jitted(donate=False)
        jp1, jo1, jm1 = fn(jp, jo, jb)
        jp2, jo2, jm2 = fn(jp1, jo1, jb)

    model = Model(port_smoke(arch), ParallelConfig(grad_accum=accum), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tb = params_from_numpy(jax.tree.map(np.asarray, jb))
    policy = tiered_adam.default_policy(tp) if opt == "tiered" else None
    assert policy == jpolicy
    to = tiered_adam.init(tp, policy) if policy else adamw.init(tp)
    step = make_train_step(model, adamw.AdamWConfig(lr=LR), ParallelConfig(grad_accum=accum),
                           tb, tiered_policy=policy).fn
    for i, (jpi, joi, jmi) in enumerate(((jp1, jo1, jm1), (jp2, jo2, jm2))):
        tp, to, tm = step(tp, to, tb)
        for key in ("loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jmi[key]), rel=METRIC_RTOL), (i, key)
        assert float(tm["lr"]) == pytest.approx(float(jmi["lr"]), rel=1e-7)
        _compare_params(jpi, tp, f"step {i + 1}")
        if policy:
            _compare_tiered(joi, to, f"step {i + 1}")
        else:
            assert int(to["step"]) == i + 1
            _compare_params(joi["m"], to["m"], f"step {i + 1} m")


def test_parallel_config_is_the_reference_field_for_field():
    assert [(f.name, f.default) for f in dataclasses.fields(ParallelConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JParallelConfig)]


def test_parallel_config_no_ops_and_remat_change_no_number():
    """fsdp, scan_layers, shard_kv_seq and grad_compress_pods do nothing on
    one device, and remat changes memory, not numbers: the losses and
    gradients are bit-equal to the default config's."""
    cfg = port_smoke("qwen3_moe_235b")
    params = Model(cfg, device="cpu").init(0, dtype=torch.float32)
    batch = make_train_batch(cfg, batch=2, seq=32, device="cpu")
    configs = [ParallelConfig(), ParallelConfig(remat="none"),
               ParallelConfig(fsdp=True, scan_layers=False, shard_kv_seq=True,
                              grad_compress_pods=True)]
    runs = [value_and_grad(Model(cfg, pc, device="cpu"), params, batch) for pc in configs]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(pytree.leaves(grads), pytree.leaves(runs[0][2])):
            assert torch.equal(a, b)
