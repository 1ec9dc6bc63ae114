"""The port's serve steps and serving example against the JAX package, on
the CPU: ``make_prefill_step`` and ``make_decode_step`` on the
``qwen1_5_4b`` SMOKE (the reference's weights carried across; logits within
``LOGIT_ATOL``, as ``tests/test_torch_model.py`` holds them), the
sequence-parallel pool attention on a one-device mesh against the
reference's shard_map and on abstract (1, 2) and (2, 2) meshes, run shard by
shard, against the unsharded pool attention (f32: rtol 1e-5, atol 1e-6),
the serving example against ``examples/serve_tiered_kv.py``, the leftover
names of ``core.pools``, ``kernels.ref`` and ``media``, and the package
exports.
"""

import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import pools as jpools  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.mesh import make_mesh as j_make_mesh  # noqa: E402
from repro.media import faults as jfaults  # noqa: E402
from repro.media.devices import get as jget_device  # noqa: E402
from repro.media.ringbuf import PinnedRing as JRing  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import serve_tiered_kv  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core import pools, tiers  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh, make_mesh  # noqa: E402
from repro_torch.media import faults  # noqa: E402
from repro_torch.media.devices import get as get_device  # noqa: E402
from repro_torch.media.ringbuf import PinnedRing  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 0.0625  # tests/test_torch_model.py: four bf16 ulps at |logit| < 4
SP_TOL = dict(rtol=1e-5, atol=1e-6)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- dense steps
@pytest.fixture(scope="module")
def qwen():
    jcfg = jconfigs.get_smoke("qwen1_5_4b")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(configs.get_smoke("qwen1_5_4b"), device="cpu")
    return jcfg, jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_prefill_and_decode_steps_match_reference(qwen):
    jcfg, jm, jp, tm, tp = qwen
    jmesh = j_make_mesh((1, 1), ("data", "model"))
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    par = ParallelConfig()
    tokens = np.random.default_rng(1).integers(1, jcfg.vocab_size, (2, 16))

    jfn, jspecs = jserve.make_prefill_step(jm, jmesh, jconfigs.base.ParallelConfig())
    fn, specs = serve.make_prefill_step(tm, mesh, par)
    with jmesh:
        want = jfn(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = fn(tp, {"tokens": torch.as_tensor(tokens)})
    assert got.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(_f32(got), _f32(tm.forward(tp, {"tokens": torch.as_tensor(
        tokens)})[0][:, -1]))
    assert specs["blocks"]["attn"]["wq"] == (None, None, "model", None)

    jstep = jserve.make_decode_step(jm, jmesh, jconfigs.base.ParallelConfig(), 2, 32)
    step = serve.make_decode_step(tm, mesh, par, 2, 32)
    assert step.token_spec == tuple(jstep.token_spec)
    assert tuple(step.state_specs.k_cache) == tuple(jstep.state_specs.k_cache)
    jstate, state = jm.init_cache(2, 32), tm.init_cache(2, 32)
    for i in range(4):  # teacher-forced: the prompt's tokens
        with jmesh:
            jl, jstate = jstep.fn(jp, jnp.asarray(tokens[:, i:i + 1], jnp.int32), jstate)
        tl, state = step.fn(tp, torch.as_tensor(tokens[:, i:i + 1]), state)
        assert tl.shape == (2, 1, jcfg.vocab_size)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=LOGIT_ATOL, rtol=0)
    assert state.cache_len == 4


# ---------------------------------------------------- sequence-parallel attention
def _pool(rng, n_rows, t, kv, hd, bits):
    x = rng.normal(0, 1, (2, n_rows, t, kv, hd)).astype(np.float32)
    kp, ks = ref.quant_kv_page(torch.from_numpy(x[0]), bits)
    vp, vs = ref.quant_kv_page(torch.from_numpy(x[1]), bits)
    return kp, ks, vp, vs


@pytest.mark.parametrize("bits", [8, 4])
def test_sp_pool_attention_one_device_matches_reference_shard_map(bits):
    rng = np.random.default_rng(5)
    b, h, kv, hd, t, mp, n_rows = 3, 4, 2, 32, 8, 6, 12
    kp, ks, vp, vs = _pool(rng, n_rows, t, kv, hd, bits)
    q = torch.from_numpy(rng.normal(0, 1, (b, h, hd)).astype(np.float32))
    table = torch.from_numpy(rng.integers(0, n_rows, (b, mp)).astype(np.int32))
    n = torch.tensor([mp, 0, 3], dtype=torch.int32)
    pool = {"k_pages": kp, "k_scales": ks, "v_pages": vp, "v_scales": vs,
            "page_table": table, "n_pages": n}
    got = serve.make_sp_pool_attention(make_mesh((1, 1), ("data", "model"), device="cpu"),
                                       ("data",))(q, pool, bits)
    jmesh = j_make_mesh((1, 1), ("data", "model"))
    with jmesh:
        want = jserve.make_sp_pool_attention(jmesh, ("data",))(
            jnp.asarray(q.numpy()), {k: jnp.asarray(v.numpy()) for k, v in pool.items()}, bits)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **SP_TOL)
    # One shard: the per-pool call itself, and nothing changed by the merge.
    one = ref.paged_quant_attention(q, kp, ks, vp, vs, table, n, bits)
    for g, w in zip(got, one):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_sp_pool_attention_sharded_in_turn_matches_unsharded(mesh_shape, bits):
    """Pages striped over (data x model): global page g on shard g % S at
    local row g // S. Valid prefixes end before, inside, at and past the
    first model shard's columns; the shard rule clamp(n - j * MP/TP, 0,
    MP/TP) must reproduce slot_pos < n_pages."""
    rng = np.random.default_rng(7)
    dp, tp = mesh_shape
    ns = dp * tp
    b, h, kv, hd, t, mp, rows = 4, 4, 2, 32, 8, 8, 5
    cols = mp // tp
    logical = _pool(rng, ns * rows, t, kv, hd, bits)
    # physical row s * rows + l holds global page l * ns + s
    g_of_phys = np.array([l_ * ns + s for s in range(ns) for l_ in range(rows)])
    phys = [x[torch.from_numpy(g_of_phys)] for x in logical]
    table = np.zeros((b, mp), np.int32)
    for r in range(b):
        bi = r // (b // dp)
        for c in range(mp):
            table[r, c] = rng.integers(0, rows) * ns + bi * tp + c // cols
    n = torch.tensor([0, 2, cols, mp - 1], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(0, 1, (b, h, hd)).astype(np.float32))
    pool = {"k_pages": phys[0], "k_scales": phys[1], "v_pages": phys[2], "v_scales": phys[3],
            "page_table": torch.from_numpy(table), "n_pages": n}
    sp = serve.make_sp_pool_attention(make_abstract_mesh(mesh_shape, ("data", "model")),
                                      ("data",))
    out, m, lsum, mass, base = sp(q, pool, bits)
    jq = jnp.asarray(q.numpy())
    w_out, w_m, w_l, w_mass, w_base = jref.paged_quant_attention(
        jq, *(jnp.asarray(x.numpy()) for x in logical), jnp.asarray(table),
        jnp.asarray(n.numpy()), bits)
    w_l = np.asarray(w_l)
    live = w_l > 0
    # The merge's reference point may differ (an empty shard's m is 0), so
    # compare the normalized output and the log-sum-exp.
    np.testing.assert_allclose(_f32(out)[live] / _f32(lsum)[live][:, None],
                               _f32(w_out)[live] / w_l[live][:, None], **SP_TOL)
    np.testing.assert_allclose(_f32(m)[live] + np.log(_f32(lsum)[live]),
                               _f32(w_m)[live] + np.log(w_l[live]), **SP_TOL)
    assert not _f32(lsum)[~live].any() and not _f32(out)[~live].any()
    np.testing.assert_allclose(_f32(mass), _f32(w_mass), **SP_TOL)
    np.testing.assert_allclose(_f32(base), _f32(w_base), **SP_TOL)
    # The plain version with global slot positions gives the same partials
    # per shard as the clamped prefix.
    for j in range(tp):
        sl = slice(j * cols, (j + 1) * cols)
        pos = torch.arange(j * cols, (j + 1) * cols, dtype=torch.int32)[None].expand(b, cols)
        a = ref.paged_quant_attention(q, *logical, pool["page_table"][:, sl].contiguous(), n,
                                      bits, slot_pos=pos)
        c = ref.paged_quant_attention(q, *logical, pool["page_table"][:, sl].contiguous(),
                                      torch.clamp(n - j * cols, 0, cols), bits)
        for x, y in zip(a, c):
            assert torch.equal(x, y)


# ------------------------------------------------------------- serving example
def _comparable(lines):
    out = []
    for line in lines:
        if line.startswith("media busy"):
            continue
        line = re.sub(r" \([0-9.]+s wall\)", "", line)
        out.append(re.sub(r" daemon_s=[0-9.]+", "", line))
    return out


def test_serving_example_matches_reference(capsys, monkeypatch):
    argv = ["--requests", "2", "--new-tokens", "8"]
    example = runpy.run_path(str(ROOT / "examples" / "serve_tiered_kv.py"))
    monkeypatch.setattr(sys, "argv", ["serve_tiered_kv.py"] + argv)
    example["main"]()
    want = capsys.readouterr().out.strip().splitlines()

    jcfg = jconfigs.get_smoke("zamba2_1_2b")
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    lines = []
    args = serve_tiered_kv.parser().parse_args(argv + ["--device", "cpu"])
    stats, reqs, eng, _ = serve_tiered_kv.run(
        configs.get_smoke("zamba2_1_2b"), args, "cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, jp)), log=lines.append)
    assert stats.completed == 2 and all(len(r.out_tokens) == 8 for r in reqs)
    assert _comparable(lines) == _comparable(want)
    assert any(line.startswith("req0: [") for line in lines)


# --------------------------------------------------------------- leftover names
def test_leftover_names_match_reference():
    rng = np.random.default_rng(3)
    block = rng.normal(0, 1, (16, 64)).astype(np.float32)
    for tid in ("C1", "C9"):
        jspec, spec = jtiers.get(tid), tiers.get(tid)
        jpool = jpools.make_tier_pool(jspec, 4, block.size)
        pool = pools.make_tier_pool(spec, 4, block.size)
        assert pool.capacity == jpool.capacity == 4
        jpool = jpools.pool_compress_block(jspec, jpool, 2, jnp.asarray(block))
        new = pools.pool_compress_block(spec, pool, 2, torch.from_numpy(block))
        assert not pool.payload.any()  # the input pool is unchanged
        np.testing.assert_array_equal(new.payload.numpy(), np.asarray(jpool.payload))
        np.testing.assert_array_equal(new.scales.numpy(), np.asarray(jpool.scales))
        got = pools.pool_decompress_block(spec, new, 2, block.shape)
        want = jpools.pool_decompress_block(jspec, jpool, 2, block.shape)
        np.testing.assert_array_equal(_f32(got), _f32(want))

    jt, tt = jpools.BlockTable(5), pools.BlockTable(5)
    assert tt.move(3, 2, 7) == jt.move(3, 2, 7) == (0, -1)
    assert tt.move(3, 1, 4) == jt.move(3, 1, 4) == (2, 7)
    np.testing.assert_array_equal(tt.placement, jt.placement)
    np.testing.assert_array_equal(tt.slot, jt.slot)

    b, h, kv, hd, t, mp = 2, 4, 2, 32, 8, 3
    q = rng.normal(0, 1, (b, h, hd)).astype(np.float32)
    rk = rng.normal(0, 1, (b, 5, kv, hd)).astype(np.float32)
    rv = rng.normal(0, 1, (b, 5, kv, hd)).astype(np.float32)
    tpools, jpools_ = {}, {}
    for name, bits in (("warm", 8), ("cold", 4)):
        kp, ks, vp, vs = _pool(rng, 4, t, kv, hd, bits)
        table = rng.integers(0, 4, (b, mp)).astype(np.int32)
        n = np.array([mp, 1], np.int32)
        tpools[name] = {"k_pages": kp, "k_scales": ks, "v_pages": vp, "v_scales": vs,
                        "page_table": torch.from_numpy(table), "n_pages": torch.from_numpy(n),
                        "bits": bits}
        jpools_[name] = {k: (v if k == "bits" else jnp.asarray(_f32(v) if k.endswith("scales")
                                                                else v.numpy()))
                         for k, v in tpools[name].items()}
    rlen = np.array([5, 2], np.int32)
    got = ref.tiered_decode_attention(torch.from_numpy(q), tpools, torch.from_numpy(rk),
                                      torch.from_numpy(rv), torch.from_numpy(rlen))
    want = jref.tiered_decode_attention(jnp.asarray(q), jpools_, jnp.asarray(rk),
                                        jnp.asarray(rv), jnp.asarray(rlen))
    np.testing.assert_allclose(_f32(got), _f32(want), **SP_TOL)
    got = ref.tiered_page_masses(torch.from_numpy(q), tpools)
    want = jref.tiered_page_masses(jnp.asarray(q), jpools_)
    assert sorted(got) == sorted(want)
    for name in got:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_allclose(_f32(g), _f32(w), **SP_TOL)

    ring, jring = PinnedRing(8, 64), JRing(8, 64)
    for n in (3, 3, 4, 1):
        assert ring.can_acquire(n) == jring.can_acquire(n)
        assert (ring.try_acquire(n) is None) == (jring.try_acquire(n) is None)
    assert ring.can_acquire(1) == jring.can_acquire(1)

    events = [("stall", "host_dram_pcie"), ("brownout", "nvme_gen4"), ("down", "cxl_dram")]
    plan = faults.FaultPlan([faults.FaultEvent(k, d, 1) for k, d in events])
    jplan = jfaults.FaultPlan([jfaults.FaultEvent(k, d, 1) for k, d in events])
    assert plan.devices() == jplan.devices()
    dev = faults.FaultyMediaDevice(get_device("host_dram_pcie"), plan)
    jdev = jfaults.FaultyMediaDevice(jget_device("host_dram_pcie"), jplan)
    assert dev.window == jdev.window == 0
    dev.note_window(5)
    jdev.note_window(5)
    assert dev.window == jdev.window == 5


def test_package_exports():
    import repro.media as jmedia
    import repro.serving as jserving
    import repro_torch.kernels as kernels
    import repro_torch.media as media
    import repro_torch.models as models
    import repro_torch.runtime as runtime
    import repro_torch.serving as serving
    from repro_torch.serving import TieredEngine  # noqa: F401
    from repro_torch.models import Model as M  # noqa: F401

    assert serving.__all__ == jserving.__all__
    for name in jserving.__all__ + ["TieredKVCache"]:
        assert hasattr(serving, name)
    for name in [n for n in dir(jmedia) if not n.startswith("_")]:
        assert hasattr(media, name), name
    assert kernels.__all__ == ["ops", "ref"] and runtime.__all__ == [
        "sharding", "train", "serve", "elastic"]
    assert models.__all__ == ["Model", "DecodeState", "init_decode_state"]
    assert configs.__all__[-3:] == ["arch_ids", "cells_for", "skipped_cells_for"]
