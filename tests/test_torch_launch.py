"""The port's launch tooling against the JAX package, on the CPU: the shape
cells, the sharding specs, the cells' parallel heuristics, abstract
arguments and model FLOPs, and the dispatch counter against the reference's
HLO analyzer.

The specs depend on axis sizes only, so both packages compute them on
abstract meshes (no devices): (2, 4), (2, 2, 2) and the production (16, 16)
and (2, 16, 16), for all ten full configs and both ``fsdp`` settings, leaf
for leaf as tuples. Abstract parameters are ``jax.eval_shape`` in the
reference and ``meta`` tensors in the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as j_abstract_mesh  # noqa: E402
from repro.launch.mesh import make_mesh as j_make_mesh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import inputs as jinputs  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.roofline import analysis as jra  # noqa: E402
from repro.roofline import hlo_stats  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.runtime import sharding as jshr  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs.base import SHAPES, ParallelConfig  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.launch.mesh import PartitionSpec as P  # noqa: E402
from repro_torch.launch.mesh import (make_abstract_mesh, make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import inputs  # noqa: E402
from repro_torch.optim import tiered_adam  # noqa: E402
from repro_torch.roofline import analysis, op_stats  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402
from repro_torch.runtime import sharding as shr  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
JP_CFG = jconfigs.base.ParallelConfig


def _jpar(par: ParallelConfig):
    return JP_CFG(**dataclasses.asdict(par))


def _jflat(tree) -> dict:
    """path -> tuple(spec) of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                     for k in path): tuple(s) for path, s in flat}


def _pflat(tree, prefix="") -> dict:
    """path -> tuple(spec) of a port spec tree (dicts, dataclasses)."""
    if isinstance(tree, P):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
                 if f.name != "policy"]
    out = {}
    for k, v in items:
        out.update(_pflat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module")
def abstract_params():
    """arch -> (reference eval_shape params, port meta params), full configs."""
    out = {}
    for arch in configs.arch_ids():
        jp = jax.eval_shape(lambda k, a=arch: JModel(jconfigs.get(a)).init(k),
                            jax.random.PRNGKey(0))
        tp = serve.abstract_params(Model(configs.get(arch), device="cpu"))
        out[arch] = (jp, tp)
    return out


def test_shapes_and_cells_equal_reference():
    assert list(SHAPES) == list(jconfigs.SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jconfigs.SHAPES[name])
    assert sorted(configs.arch_ids()) == sorted(jconfigs.arch_ids())
    for arch in configs.arch_ids():
        assert configs.cells_for(arch) == jconfigs.cells_for(arch), arch
        assert configs.skipped_cells_for(arch) == jconfigs.skipped_cells_for(arch), arch


def test_meta_params_match_reference_shapes(abstract_params):
    for arch, (jp, tp) in abstract_params.items():
        flat = jax.tree_util.tree_leaves_with_path(jp)
        for path, leaf in flat:
            node = tp
            for k in path:
                node = node[k.key]
            assert node.device.type == "meta"
            assert tuple(node.shape) == leaf.shape, (arch, path)
            assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype), (arch, path)


@pytest.mark.parametrize("mesh_shape, axes", MESHES)
def test_specs_equal_reference(abstract_params, mesh_shape, axes):
    """Param, AdamW-state, ZeRO-1 moment, batch, decode-state and tiered-KV
    specs, leaf for leaf, for every full config and both fsdp settings."""
    jm, tm = j_abstract_mesh(mesh_shape, axes), make_abstract_mesh(mesh_shape, axes)
    for arch, (jp, tp) in abstract_params.items():
        cfg = configs.get(arch)
        for fsdp in (False, True):
            par = ParallelConfig(fsdp=fsdp, shard_kv_seq=True)
            jspecs = jshr.param_specs(jp, jconfigs.get(arch), jm, _jpar(par))
            tspecs = shr.param_specs(tp, cfg, tm, par)
            assert _pflat(tspecs) == _jflat(jspecs), (arch, fsdp)
            assert _pflat(shr.opt_state_specs(tspecs)) == _jflat(jshr.opt_state_specs(jspecs))
            assert (_pflat(shr.zero1_moment_specs(tspecs, tp, tm))
                    == _jflat(jshr.zero1_moment_specs(jspecs, jp, jm))), (arch, fsdp)
            assert shr.shardings_for(tp, cfg, tm, par)["embed"] == (tm, tspecs["embed"])
        for shape in SHAPES.values():
            batch = {k: torch.empty(s, dtype=d, device="meta") for k, (s, d) in
                     inputs.train_batch_spec(cfg, shape.global_batch, 64).items()}
            jbatch = jinputs.train_batch_spec(jconfigs.get(arch), shape.global_batch, 64)
            assert _pflat(shr.batch_spec(tm, batch)) == _jflat(jshr.batch_spec(jm, jbatch))
            for kvseq in (False, True):
                par = ParallelConfig(shard_kv_seq=kvseq)
                for max_len in (shape.seq_len, shape.seq_len + 64 + 1):
                    got = shr.decode_state_specs(cfg, tm, par, shape.global_batch, max_len)
                    want = jshr.decode_state_specs(jconfigs.get(arch), jm, _jpar(par),
                                                   shape.global_batch, max_len)
                    assert _pflat(got) == _jflat(want), (arch, shape.name, kvseq)
                for pages in (0, 7, shape.seq_len // 64 * shape.global_batch):
                    got = serve.tiered_kv_state_specs(tm, par, shape.global_batch, pages)
                    want = jserve.tiered_kv_state_specs(jm, _jpar(par), shape.global_batch,
                                                        pages)
                    assert _pflat(got) == _jflat(want), (arch, shape.name, kvseq, pages)
        act = shr.activation_sharding(tm, ParallelConfig(shard_kv_seq=True), 8)
        ref = jshr.activation_sharding(jm, JP_CFG(shard_kv_seq=True), 8)
        assert (act.batch, act.heads, act.kv_seq, act.tp) == (ref.batch, ref.heads, ref.kv_seq,
                                                              ref.tp)
        x = torch.ones(2)
        assert act.constrain(x, P(None)) is x


@pytest.mark.parametrize("mesh_shape, axes", MESHES[:2])
def test_tiered_moment_specs_equal_reference(abstract_params, mesh_shape, axes):
    """The MoE train cell's tiered-Adam state specs (the reference builds
    them in ``make_train_step``)."""
    arch = "qwen3_moe_235b"
    jp, tp = abstract_params[arch]
    jm, tm = j_abstract_mesh(mesh_shape, axes), make_abstract_mesh(mesh_shape, axes)
    par = ParallelConfig(fsdp=True)
    policy = cells.moe_tiered_policy(tp)
    assert policy == jcells.moe_tiered_policy(jp)
    jbatch = jinputs.train_batch_spec(jconfigs.get(arch), 8, 16)
    jstep = jtrain.make_train_step(JModel(jconfigs.get(arch), _jpar(par)), jadamw.AdamWConfig(),
                                   jm, _jpar(par), jbatch, policy)
    got = shr.tiered_opt_specs(shr.param_specs(tp, configs.get(arch), tm, par),
                               tiered_adam.init(tp, policy), tm)
    assert _pflat(got) == _jflat(jstep.opt_specs)


def test_param_specs_divisibility_respected(abstract_params):
    """Every spec must divide its dimension on the production mesh shape."""
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    for arch, (_, params) in abstract_params.items():
        cfg = configs.get(arch)
        for parallel in (ParallelConfig(fsdp=False), ParallelConfig(fsdp=True)):
            specs = shr.param_specs(params, cfg, mesh, parallel)

            def check(leaf, spec):
                for dim, names in zip(leaf.shape, spec):
                    if names is None:
                        continue
                    ns = names if isinstance(names, tuple) else (names,)
                    size = int(np.prod([mesh.shape[n] for n in ns]))
                    assert dim % size == 0, (arch, leaf.shape, spec)

            shr._map(check, params, specs)


def test_batch_axes_divisibility():
    mesh = make_abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert shr.batch_axes_for(mesh, 8) == ("pod", "data")
    assert shr.batch_axes_for(mesh, 2) == ("pod",)
    assert shr.batch_axes_for(mesh, 1) == ()
    assert shr.batch_axes_for(mesh, 3) == ()


def test_meshes():
    m = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.device.type == "cpu" and m.size == 1
    with pytest.raises(ValueError):
        make_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        make_mesh((1, 1), ("data", "model"), device="meta")
    prod = make_production_mesh(multi_pod=True)
    assert prod.device is None and prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh().size == 256
    assert P("data", None) == ("data", None) and P() == ()


def test_default_parallel_and_model_flops_equal_reference():
    for mesh_shape, axes in MESHES + [((1, 1), ("data", "model"))]:
        jm, tm = j_abstract_mesh(mesh_shape, axes), make_abstract_mesh(mesh_shape, axes)
        for arch in configs.arch_ids():
            for shape in configs.cells_for(arch):
                got = cells.default_parallel(configs.get(arch), shape, tm)
                want = jcells.default_parallel(jconfigs.get(arch), shape, jm)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, shape)
    for arch in configs.arch_ids():
        for smoke in (False, True):
            cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
            jcfg = jconfigs.get_smoke(arch) if smoke else jconfigs.get(arch)
            for name, shape in SHAPES.items():
                assert (analysis.model_flops_for(cfg, shape)
                        == jra.model_flops_for(jcfg, jconfigs.SHAPES[name])), (arch, name)


def _port_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in _port_leaves(c)]
    if dataclasses.is_dataclass(tree):
        names = getattr(tree, "PYTREE_FIELDS", None) or [f.name for f in dataclasses.fields(tree)]
        return [x for n in names for x in _port_leaves(getattr(tree, n))]
    return []  # a static field (DecodeState.cache_len)


@pytest.mark.parametrize("arch", sorted(configs.ARCH_IDS))
def test_build_cell_abstract_args_equal_reference(arch):
    jm = j_make_mesh((1, 1), ("data", "model"))
    tm = make_abstract_mesh((1, 1), ("data", "model"))
    for shape in configs.cells_for(arch):
        jc = jcells.build_cell(arch, shape, jm, smoke=True)
        tc = cells.build_cell(arch, shape, tm, smoke=True)
        assert (tc.kind, tc.notes, tc.donate) == (jc.kind, jc.notes, jc.donate)
        want = [x for x in jax.tree.leaves(jc.abstract_args)
                if not (x.shape == () and x.dtype == jnp.int32 and tc.kind == "decode")]
        got = _port_leaves(tc.abstract_args)
        assert all(t.device.type == "meta" for t in got)
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in got] == \
            [(x.shape, str(x.dtype)) for x in want], (arch, shape)


def test_op_stats_counts_every_loop_trip():
    """The dispatch counter's FLOPs equal the reference's HLO analyzer's on
    tests/test_runtime.py's three programs (a scanned matmul, nested scans,
    an unlooped matmul), written as Python loops."""
    n, trips = 128, 7

    def f(w, x):
        def body(h, _):
            return jnp.tanh(h @ w), None
        return jax.lax.scan(body, x, None, length=trips)[0]

    def g(w, x):
        h = x
        for _ in range(trips):
            h = torch.tanh(h @ w)
        return h

    ref = hlo_stats.analyze(jax.jit(f).lower(jnp.zeros((n, n)), jnp.zeros((4, n)))
                            .compile().as_text())
    got = op_stats.analyze(g, torch.zeros(n, n), torch.zeros(4, n))
    assert got.flops == ref.flops == 2 * 4 * n * n * trips
    assert got.n_matmuls == trips

    n, outer, inner = 64, 3, 5

    def f2(w, x):
        def outer_body(h, _):
            return jax.lax.scan(lambda g_, _: (g_ @ w, None), h, None, length=inner)[0], None
        return jax.lax.scan(outer_body, x, None, length=outer)[0]

    def g2(w, x):
        h = x
        for _ in range(outer):
            for _ in range(inner):
                h = h @ w
        return h

    ref = hlo_stats.analyze(jax.jit(f2).lower(jnp.zeros((n, n)), jnp.zeros((2, n)))
                            .compile().as_text())
    got = op_stats.analyze(g2, torch.zeros(n, n, device="meta"), torch.zeros(2, n, device="meta"))
    assert got.flops == ref.flops == 2 * 2 * n * n * outer * inner

    ref = hlo_stats.analyze(jax.jit(lambda a, b: a @ b).lower(jnp.zeros((32, 64)),
                                                              jnp.zeros((64, 16)))
                            .compile().as_text())
    got = op_stats.analyze(lambda a, b: a @ b, torch.zeros(32, 64), torch.zeros(64, 16))
    assert got.flops == ref.flops == 2 * 32 * 64 * 16
    # Bytes: two f32 operands read and the result written, once.
    assert got.traffic_bytes == 4 * (32 * 64 + 64 * 16 + 32 * 16)


@pytest.mark.parametrize("arch, shape", [("zamba2_1_2b", "decode_32k"),
                                         ("internlm2_20b", "train_4k"),
                                         ("qwen1_5_4b", "long_500k")])
def test_dryrun_extrapolation_is_exact(arch, shape):
    """Counts from cut cells (depths, microbatches) extrapolate to the whole
    cell's count: the hybrid's shared block and grad accumulation included."""
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    whole = dryrun.count_cell(arch, shape, mesh, smoke=True, extrapolate=False)
    cut = dryrun.count_cell(arch, shape, mesh, smoke=True, extrapolate=True)
    assert cut["flops"] == pytest.approx(whole["flops"], rel=1e-12)
    assert cut["bytes"] == pytest.approx(whole["bytes"], rel=1e-12)


def test_dryrun_writes_reports(tmp_path):
    rc = dryrun.main(["--arch", "qwen1_5_4b", "--shape", "decode_32k", "--smoke", "--mesh", "all",
                      "--out", str(tmp_path)])
    assert rc == 0
    import json

    one = json.loads((tmp_path / "qwen1_5_4b__decode_32k__h100x1.json").read_text())
    assert one["device"] == "NVIDIA H100 80GB HBM3" and one["collective_s"] == 0.0
    assert one["memory_s"] == one["bytes_pd"] / analysis.H100.hbm_bw
    assert one["compute_s"] == one["flops_pd"] / 989.4e12 and one["flops_pd"] > 0
    pod = json.loads((tmp_path / "qwen1_5_4b__decode_32k__pod16x16.json").read_text())
    assert set(pod) >= {"args_bytes_pd", "chips"} and "flops_pd" not in pod
    assert pod["args_bytes_pd"] < one["args_bytes_pd"]
