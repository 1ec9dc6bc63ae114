"""The port's control plane against the JAX package, on the CPU: configs,
slot allocation, the tier/TCO model and the TierScape manager (whose plans
must be bit-identical for the same telemetry), plus the import isolation of
the port."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core import manager as jmanager  # noqa: E402
from repro.core import pools as jpools  # noqa: E402
from repro.core import tco as jtco  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import manager as tmanager  # noqa: E402
from repro_torch.core import pools as tpools  # noqa: E402
from repro_torch.core import tco as ttco  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_model_configs_equal_reference(which):
    j = getattr(__import__("repro.configs.qwen1_5_4b", fromlist=[which]), which)
    t = tcfg.get("qwen1_5_4b") if which == "CONFIG" else tcfg.get_smoke("qwen1_5_4b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.head_dim_() == j.head_dim_() and t.param_count() == j.param_count()
    if which == "CONFIG":
        assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.d_ff, t.vocab_size) == (
            40, 2560, 20, 20, 6912, 151936)


def test_run_configs_equal_reference_field_for_field():
    jf = [(f.name, f.type) for f in dataclasses.fields(jbase.TierScapeRunConfig)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tbase.TierScapeRunConfig)]
    assert tf == jf
    assert dataclasses.asdict(tbase.TierScapeRunConfig()) == dataclasses.asdict(
        jbase.TierScapeRunConfig())
    kw = dict(enabled=True, policy="waterfall", alpha=0.2, window_steps=6,
              async_migration=False, prefetch=False, warm_bits=4)
    assert dataclasses.asdict(tbase.TierScapeRunConfig(**kw)) == dataclasses.asdict(
        jbase.TierScapeRunConfig(**kw))
    assert [f.name for f in dataclasses.fields(tbase.ModelConfig)] == [
        f.name for f in dataclasses.fields(jbase.ModelConfig)]
    # All ten archs of the reference are registered; an unknown name raises.
    from repro.configs import ARCH_IDS as jarch_ids

    assert sorted(tcfg.ARCH_IDS) == sorted(jarch_ids)
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get("gpt_oss_120b")


def _drive_allocators(mod):
    """One sequence of allocator operations; returns everything observable."""
    trace = []
    a = mod.SlotAllocator(6, {"x": 3, "y": 2}, base=4)
    b = mod.SlotAllocator(5, base=0)
    trace.append([a.alloc(i, "x" if i % 2 else "y") for i in range(4)])
    trace.append([b.alloc(10 + i) for i in range(3)])
    a.free(trace[0][1])
    trace.append(mod.exchange_slots(b, a, trace[1][0], 99, "x"))
    trace.append((list(a._free), list(b._free), a.used, b.used, a.used_by("x"), a.used_by("y")))
    for bad in (lambda: a.free(12345), lambda: b.free(trace[1][0])):
        with pytest.raises(KeyError):
            bad()
    with pytest.raises(MemoryError):
        a.alloc(50, "y")  # y is at quota
    with pytest.raises(ValueError):
        a.alloc(51)  # untenanted alloc on a quota'd pool
    with pytest.raises(KeyError):
        a.alloc(52, "z")
    with pytest.raises(ValueError):
        mod.SlotAllocator(2, {"x": 3})
    small = mod.SlotAllocator(1)
    small.alloc(0)
    with pytest.raises(MemoryError):
        small.alloc(1)
    part = mod.ClassPartition([("warm", 8, 5), ("cold", 4, 7), ("spare", 8, 2)])
    trace.append([(r.name, r.bits, r.base, r.capacity) for r in part.ranges.values()])
    trace.append((part.class_rows(8), part.class_rows(4), part.class_rows(2), part.base("spare")))
    with pytest.raises(ValueError):
        mod.ClassPartition([("a", 8, 1), ("a", 4, 1)])
    return trace


def test_slot_allocator_and_partition_contracts_match_reference():
    assert _drive_allocators(tpools) == _drive_allocators(jpools)


def test_tier_and_tco_model_equal_reference():
    jt = jkv.kv_tierset(16 * 20 * 128 * 2)
    tt = tkv.kv_tierset(16 * 20 * 128 * 2)
    assert [t.tid for t in tt.tiers] == [t.tid for t in jt.tiers]
    assert tt.latencies_s() == jt.latencies_s()
    assert tt.ratios() == jt.ratios()
    assert tt.usd_per_source_byte() == jt.usd_per_source_byte()
    assert [d.name for d in tt.media_devices()] == [d.name for d in jt.media_devices()]
    rng = np.random.default_rng(0)
    placement = rng.integers(0, 5, 300)
    ratios = np.asarray(jt.ratios()[1:]) * 1.1
    assert ttco.tco_nt(tt, placement, 2048, ratios) == jtco.tco_nt(jt, placement, 2048, ratios)
    assert ttco.savings_pct(tt, placement, 2048) == jtco.savings_pct(jt, placement, 2048)


@pytest.mark.parametrize("preset", ["6T-AM-0.5", "6T-AM-0.1", "6T-WF-M", "2T-C", "7T-CX-0.5"])
def test_manager_plans_bit_identical(preset):
    """The same seeded telemetry for several windows, with fault-backs and a
    measured-ratio update: every window's plan (regions, src, dst, bytes,
    modeled time), placement and stats are identical."""
    n = 512
    mgrs = [mod.make_manager(preset, n, thresholds={"C": 40.0, "M": 90.0, "A": 200.0})
            for mod in (jmanager, tmanager)]
    rng = np.random.default_rng(11)
    for w in range(6):
        counts = rng.gamma(0.6, 60.0, n) * (rng.random(n) < 0.7)
        faults = rng.choice(n, 8, replace=False)
        plans = []
        for m in mgrs:
            m.record_access_counts(counts)
            m.fault_back(faults, n_blocks=3)
            m.update_measured_ratio(1, 1.7 + 0.05 * w)
            plans.append(m.end_window())
        jp, tp = plans
        np.testing.assert_array_equal(tp.regions, jp.regions)
        np.testing.assert_array_equal(tp.src, jp.src)
        np.testing.assert_array_equal(tp.dst, jp.dst)
        assert (tp.bytes_moved, tp.modeled_migration_s, tp.n_cohorts) == (
            jp.bytes_moved, jp.modeled_migration_s, jp.n_cohorts)
        assert tp.media_bytes_by_device == jp.media_bytes_by_device
        np.testing.assert_array_equal(mgrs[1].placement, mgrs[0].placement)
        hj, ht = mgrs[0].history[-1], mgrs[1].history[-1]
        assert (ht.tco_usd, ht.savings_pct, ht.migrations) == (hj.tco_usd, hj.savings_pct,
                                                               hj.migrations)
    assert mgrs[0].history[-1].migrations >= 0 and len(mgrs[1].history) == 6


def test_manager_plans_for_the_engine_tierset_bit_identical():
    n = 640
    cfg = jmanager.ManagerConfig(policy="analytical", alpha=0.3, window_steps=6)
    ts_j, ts_t = jkv.kv_tierset(8 * 4 * 16 * 2), tkv.kv_tierset(8 * 4 * 16 * 2)
    mj = jmanager.TierScapeManager(ts_j, n, region_bytes=8 * 4 * 16 * 4, cfg=cfg)
    mt = tmanager.TierScapeManager(ts_t, n, region_bytes=8 * 4 * 16 * 4,
                                   cfg=tmanager.ManagerConfig(**dataclasses.asdict(cfg)))
    rng = np.random.default_rng(4)
    for _ in range(5):
        counts = rng.random(n).astype(np.float32).astype(np.float64) * 1000.0
        mj.record_access_counts(counts)
        mt.record_access_counts(counts)
        pj, pt = mj.end_window(), mt.end_window()
        np.testing.assert_array_equal(pt.regions, pj.regions)
        np.testing.assert_array_equal(pt.dst, pj.dst)
    np.testing.assert_array_equal(mt.placement, mj.placement)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "train_step_profile.py"]
    assert len(files) > 20
    for mod in ("models/moe", "models/inputs", "core/simulator", "core/arbiter",
                "core/capacity", "quickstart", "pytree", "optim/adamw", "optim/tiered_adam",
                "optim/grad_compress", "runtime/train", "runtime/elastic", "data/pipeline",
                "checkpoint/ckpt", "train_tiered_lm", "serve_tiered_kv", "runtime/sharding",
                "launch/mesh", "launch/cells", "launch/dryrun", "roofline/analysis",
                "roofline/op_stats"):
        assert ROOT / "src" / "repro_torch" / f"{mod}.py" in files
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
