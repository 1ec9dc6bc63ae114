"""The port's substrates: the data pipeline (``repro_torch.data``),
checkpointing (``repro_torch.checkpoint``) and the elastic runtime
(``repro_torch.runtime.elastic``), on the CPU.

The reference's ``tests/test_substrates.py`` and its two checkpoint
integrity tests of ``tests/test_faults.py`` run on the port. The corpus is
byte-equal to the reference's for every (seed, step, shard) tried. A
checkpoint the JAX package wrote (bf16, f32, int8 and int32 leaves, a
tiered optimizer state) restores into the port bit for bit under the
reference's keys, and one the port wrote has the reference's manifest
(keys, shapes, dtypes, digest rule). The reference's own restore of a bf16
leaf returns ``|V2`` void bytes that JAX refuses; the port's returns
``torch.bfloat16``.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.optim import tiered_adam as jtiered  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.checkpoint import CheckpointCorrupt, CheckpointManager  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data.pipeline import DataConfig, HostLoader, synthetic_corpus  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import tiered_adam  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_corpus_deterministic_and_sharded():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=8, num_shards=2, shard_id=0)
    a = synthetic_corpus(cfg, step=3)
    b = synthetic_corpus(cfg, step=3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    cfg1 = DataConfig(vocab_size=1000, seq_len=64, global_batch=8, num_shards=2, shard_id=1)
    c = synthetic_corpus(cfg1, step=3)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (4, 64)
    assert (a["targets"][:, :-1] == a["tokens"][:, 1:]).all()
    assert a["tokens"].max() < 1000


@pytest.mark.parametrize("seed, step, shard, pack", [
    (1234, 0, 0, True), (1234, 7, 1, True), (7, 3, 3, True), (99, 12, 0, False),
])
def test_corpus_byte_equal_to_reference(seed, step, shard, pack):
    kw = dict(vocab_size=151936, seq_len=512, global_batch=8, num_shards=4, shard_id=shard,
              seed=seed, pack_documents=pack, mean_doc_len=96)
    got = synthetic_corpus(DataConfig(**kw), step)
    want = jpipeline.synthetic_corpus(jpipeline.DataConfig(**kw), step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_loader_prefetch_and_close():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, prefetch=2)
    loader = HostLoader(cfg)
    b1 = next(loader)
    b2 = next(loader)
    assert b1["tokens"].shape == (4, 16)
    assert not np.array_equal(b1["tokens"], b2["tokens"])
    loader.close()
    assert not loader._thread.is_alive()


def test_loader_straggler_mitigation():
    """A stalled producer must not stall the consumer."""
    def slow_make(cfg, step):
        if step >= 2:
            time.sleep(5.0)  # straggler
        return synthetic_corpus(cfg, step)

    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2, prefetch=1,
                     straggler_timeout_s=0.5)
    loader = HostLoader(cfg, make_batch=slow_make)
    got = [next(loader) for _ in range(5)]
    assert len(got) == 5
    assert loader.straggler_events >= 1
    loader.close()


def test_loader_resumes_the_token_stream():
    """A loader started at step s yields the batches an uninterrupted one
    yields from s (what a resumed run relies on)."""
    cfg = DataConfig(vocab_size=500, seq_len=32, global_batch=2)
    full, resumed = HostLoader(cfg), HostLoader(cfg, start_step=3)
    try:
        a = [next(full) for _ in range(5)][3:]
        b = [next(resumed) for _ in range(2)]
    finally:
        full.close()
        resumed.close()
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _state():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones((4,))},
        "opt": {"m": {"w": torch.zeros((3, 4)), "b": torch.zeros((4,))},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(42, state)
    step, restored = mgr.restore(state)
    assert step == 42
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert int(restored["opt"]["step"]) == 7 and restored["opt"]["step"].dtype == torch.int32


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=False)
    mgr.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2
    assert mgr.latest_step() == 4


def test_checkpoint_atomicity_torn_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(1, state)
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "params.npz").write_bytes(b"garbage")
    step, _ = mgr.restore(state)
    assert step == 1


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(1, state)
    p = tmp_path / "step_00000001" / "params.npz"
    data = bytearray(p.read_bytes())
    data[len(data) // 2] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(Exception):
        mgr.restore(state)


def test_async_save_snapshots_before_an_in_place_update(tmp_path):
    """The optimizers write parameters in place; an async save taken before
    such a write holds the values at the save."""
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    want = state["params"]["w"].clone()
    mgr.save(1, state, blocking=False)
    state["params"]["w"].add_(1.0)
    _, restored = mgr.restore(_state())
    assert torch.equal(restored["params"]["w"], want)


def _ckpt_state():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}}


def test_checkpoint_detects_shard_and_manifest_tampering(tmp_path):
    root = str(tmp_path / "a")
    mgr = CheckpointManager(root)
    mgr.save(3, _ckpt_state())
    step, out = mgr.restore(_ckpt_state())
    assert step == 3
    assert torch.equal(out["params"]["w"], _ckpt_state()["params"]["w"])
    shard = os.path.join(root, "step_00000003", "params.npz")
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(blob))
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(_ckpt_state())

    root = str(tmp_path / "b")
    mgr = CheckpointManager(root)
    mgr.save(4, _ckpt_state())
    mpath = os.path.join(root, "step_00000004", "MANIFEST.json")
    manifest = json.load(open(mpath))
    manifest["crc"]["params"] ^= 1
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(_ckpt_state())


def test_checkpoint_without_digest_stays_loadable(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _ckpt_state())
    mpath = os.path.join(str(tmp_path), "step_00000005", "MANIFEST.json")
    manifest = json.load(open(mpath))
    del manifest["digest"]
    json.dump(manifest, open(mpath, "w"))
    step, out = mgr.restore(_ckpt_state())
    assert step == 5
    assert torch.equal(out["params"]["w"], _ckpt_state()["params"]["w"])


def _mixed_tree(rng):
    return {
        "embed": rng.normal(0, 1, (16, 8)).astype(np.float32),
        "blocks": {"wq": rng.normal(0, 1, (2, 8, 4)).astype(np.float32),
                   "norm": rng.normal(0, 1, (2, 8)).astype(np.float32)},
        "codes": rng.integers(-127, 128, (5, 7)).astype(np.int8),
        "step": np.asarray(9, np.int32),
        "list": [rng.normal(0, 1, (3,)).astype(np.float32)],
    }


def _bits(x):
    """A leaf's dtype name and raw bytes (bf16 by its bit patterns)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.dtype).replace("torch.", ""), x.numpy().tobytes()
    return str(x.dtype), np.asarray(x).tobytes()


def test_jax_written_checkpoint_restores_bit_for_bit(tmp_path):
    """bf16, f32, int8 and int32 leaves and a tiered optimizer state (its
    ``.m/...`` keys), written by the JAX package."""
    rng = np.random.default_rng(0)
    tree = _mixed_tree(rng)
    jparams = {"embed": jnp.asarray(tree["embed"], jnp.bfloat16),
               "blocks": {"wq": jnp.asarray(tree["blocks"]["wq"], jnp.bfloat16),
                          "norm": jnp.asarray(tree["blocks"]["norm"])}}
    jopt = jtiered.init(jparams, jtiered.default_policy(jparams))
    jstate = {"params": dict(jax.tree.map(jnp.asarray, tree), embed=jparams["embed"]),
              "tiered": jparams, "opt": jopt}
    JCheckpointManager(str(tmp_path)).save(11, jstate)

    example = {
        "params": params_from_numpy(jax.tree.map(np.asarray, jstate["params"])),
        "tiered": params_from_numpy(jax.tree.map(np.asarray, jparams)),
        "opt": tiered_adam.TieredAdamState(
            *[params_from_numpy(jax.tree.map(np.asarray, getattr(jopt, f)))
              for f in ("m", "m_scales", "v", "v_scales")],
            step=torch.tensor(0, dtype=torch.int32), policy=jopt.policy),
    }
    step, out = CheckpointManager(str(tmp_path)).restore(pytree.tree_map(torch.zeros_like,
                                                                         example))
    assert step == 11
    assert isinstance(out["opt"], tiered_adam.TieredAdamState)
    assert out["opt"].policy == jopt.policy
    want = []
    for name in sorted(jstate):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jstate[name])[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            want.append((f"{name}/{key}", leaf))
    got = pytree.leaves_with_path(out)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert "opt/.m/embed" in dict(got)
    for (key, t), (_, j) in zip(got, want):
        assert _bits(t) == _bits(np.asarray(j)), key
    assert out["params"]["embed"].dtype == torch.bfloat16


def test_port_checkpoint_has_the_reference_manifest(tmp_path):
    """The port writes the reference's keys (JAX's order, ``.m/...`` for the
    tiered state), shapes and dtype names, and its digest rule."""
    rng = np.random.default_rng(1)
    tree = _mixed_tree(rng)
    jp = jax.tree.map(jnp.asarray, tree)
    jp["embed"] = jp["embed"].astype(jnp.bfloat16)
    fp = {"embed": jp["embed"], "w": jp["blocks"]["wq"]}
    policy = jtiered.default_policy(fp)
    jstate = {"params": jp, "opt": jtiered.init(fp, policy)}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tstate = {"params": tp, "opt": tiered_adam.init(params_from_numpy(
        jax.tree.map(np.asarray, fp)), policy)}
    JCheckpointManager(str(tmp_path / "j")).save(2, jstate)
    CheckpointManager(str(tmp_path / "t")).save(2, tstate)
    jm = json.load(open(tmp_path / "j" / "step_00000002" / "MANIFEST.json"))
    tm = json.load(open(tmp_path / "t" / "step_00000002" / "MANIFEST.json"))
    assert tm["meta"] == jm["meta"] and tm.keys() == jm.keys()
    assert tm["digest"] == ckpt._manifest_digest(tm["step"], tm["meta"], tm["crc"])


def test_reference_restore_of_bf16_returns_void_bytes_and_the_port_does_not(tmp_path):
    """A fault of the reference that the port does not copy: its restore
    hands back a bf16 leaf as ``|V2`` bytes, which ``jnp.asarray`` refuses
    (so ``examples/train_tiered_lm.py --resume`` cannot resume bf16
    params); the port restores the same files as ``torch.bfloat16``."""
    x = jnp.asarray(np.random.default_rng(2).normal(0, 1, (4, 6)), jnp.bfloat16)
    jmgr = JCheckpointManager(str(tmp_path))
    jmgr.save(1, {"params": {"w": x}})
    manifest = json.load(open(tmp_path / "step_00000001" / "MANIFEST.json"))
    assert manifest["meta"]["params"][0]["dtype"] == "bfloat16"
    _, jout = jmgr.restore({"params": {"w": x}})
    assert jout["params"]["w"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jnp.asarray(jout["params"]["w"])
    _, tout = CheckpointManager(str(tmp_path)).restore(
        {"params": {"w": torch.zeros((4, 6), dtype=torch.bfloat16)}})
    w = tout["params"]["w"]
    assert w.dtype == torch.bfloat16
    assert w.view(torch.int16).numpy().tobytes() == np.asarray(x).view(np.int16).tobytes()


# ---------------------------------------------------------------------------
# elastic runtime
# ---------------------------------------------------------------------------


def test_plan_remesh_keeps_tp_sheds_dp():
    plan = elastic.plan_remesh(
        n_devices=256, model_parallel=16, global_batch=256, microbatch_per_replica=16)
    assert plan.shape == (16, 16)
    survivors = elastic.plan_remesh(
        n_devices=192, model_parallel=16, global_batch=256, microbatch_per_replica=16)
    assert survivors.shape == (12, 16)
    assert survivors.grad_accum >= plan.grad_accum


def test_plan_remesh_refuses_below_tp():
    with pytest.raises(ValueError):
        elastic.plan_remesh(8, model_parallel=16, global_batch=64, microbatch_per_replica=1)


def test_elastic_runner_failure_restore_resume():
    saved = {}

    def build_step(plan):
        def step(state, batch):
            return {"x": state["x"] + batch}
        return step

    def save_fn(step, state):
        saved["ckpt"] = (step, {"x": state["x"]})

    restores = []

    def restore_fn():
        step, st = saved["ckpt"]
        restores.append(step)
        return step, dict(st)

    failed = {"done": False}

    def fail_hook(step):
        if step == 7 and not failed["done"]:
            failed["done"] = True
            return 192
        return None

    runner = elastic.ElasticRunner(
        build_step, save_fn, restore_fn,
        initial_plan=elastic.plan_remesh(256, 16, 256, 16),
        checkpoint_every=2, fail_hook=fail_hook, model_parallel=16, global_batch=256,
        microbatch_per_replica=16,
    )
    final_step, state = runner.run({"x": 0}, iter(range(1, 1000)), n_steps=10)
    assert final_step == 10
    assert len(runner.remesh_events) == 1
    assert runner.remesh_events[0][2].n_devices == 192
    assert restores and restores[0] <= 7
