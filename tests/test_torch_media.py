"""The port's media subsystem against the JAX package, on the CPU.

The ring, the device queues and the fault plans are driven with the same
operations as the reference objects and must agree exactly: credit grants,
watermark hysteresis, the speculative slice, staged bytes, virtual-time
charges and RNG-free fault replay. On the port's own cache, the async
pipeline must land the serial executor's placements and payloads bit for
bit (as ``tests/test_media.py`` holds the reference), prefetch hits must
commit what a prefetch-free run commits (``tests/test_prefetch.py``), and a
fault storm must give the same placements in both modes
(``tests/test_faults.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.media import devices as jdevices  # noqa: E402
from repro.media import faults as jfaults  # noqa: E402
from repro.media.ringbuf import PinnedRing as JRing  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.manager import ManagerConfig  # noqa: E402
from repro_torch.media import devices, faults  # noqa: E402
from repro_torch.media.ringbuf import PinnedRing  # noqa: E402
from repro_torch.serving.kv_cache import (  # noqa: E402
    COLD, HOST4, HOST8, INFLIGHT, WARM, TieredKVCache,
)

CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)


# ---------------------------------------------------------------------------
# pinned ring: the same operations on both rings, the same observations
# ---------------------------------------------------------------------------


def _ring_trace(ring_cls, ops_seq, n_slots=16, **kw):
    r = ring_cls(n_slots, 32, **kw)
    held, trace = [], []
    for op, n in ops_seq:
        if op in ("acq", "spec"):
            got = r.try_acquire(n, speculative=op == "spec")
            if got is not None:
                held.append(got)
            trace.append(got)
        else:  # release the n-th oldest grant still held
            if held:
                r.release(held.pop(min(n, len(held) - 1)))
            trace.append(None)
        trace.append((r.free_slots, r.held_slots, r.spec_held_slots, r.backpressured,
                       r.stalls, r.spec_rejects, r.acquires, r.spec_acquires))
        assert r.free_slots + r.held_slots == n_slots
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_ring_credit_protocol_matches_reference(seed):
    """Random demand/speculative acquire and release sequences: the same
    grants, backpressure flips (hysteresis between the watermarks), stalls
    and speculative refusals as the reference ring."""
    rng = np.random.default_rng(seed)
    seq = [(str(rng.choice(["acq", "acq", "spec", "rel", "rel"])), int(rng.integers(0, 7)))
           for _ in range(60)]
    kw = dict(low_watermark=0.125, high_watermark=0.5, spec_reserve=0.25)
    assert _ring_trace(PinnedRing, seq, **kw) == _ring_trace(JRing, seq, **kw)


def test_ring_watermark_hysteresis_and_double_release():
    for cls in (PinnedRing, JRing):
        r = cls(8, 16, low_watermark=0.125, high_watermark=0.5)
        a, b = r.try_acquire(4), r.try_acquire(3)  # 1 free: at the low watermark
        assert a is not None and b is not None and r.backpressured
        assert r.try_acquire(1) is None  # stalled despite a free slot
        r.release(b[:2])
        assert r.backpressured and r.try_acquire(1) is None  # 3 free < high (4)
        r.release(b[2:])
        assert not r.backpressured and r.try_acquire(1) is not None
        with pytest.raises(ValueError):
            r.release(b)  # already released


def test_ring_bytes_roundtrip_matches_reference():
    r, j = PinnedRing(4, 8), JRing(4, 8)
    s, sj = r.try_acquire(2), j.try_acquire(2)
    assert s == sj
    rows = torch.arange(12, dtype=torch.uint8).reshape(2, 6)
    r.stage_rows(s, rows)
    for slot, row in zip(sj, rows):
        j.stage(slot, row.numpy().tobytes())
    assert [r.view(x).numpy().tobytes() for x in s] == [j.read(x) for x in sj]
    with pytest.raises(ValueError):
        r.stage_rows(s[:1], torch.zeros((1, 9), dtype=torch.uint8))  # exceeds slot_bytes
    with pytest.raises(ValueError):
        r.view(next(x for x in range(4) if x not in s))  # unheld slot


# ---------------------------------------------------------------------------
# device queues: identical virtual-time accounting for every preset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jdevices.DEVICES))
def test_media_queue_replay_matches_reference(name):
    assert devices.get(name) == devices.DEVICES[name]
    jd, td = jdevices.get(name), devices.get(name)
    assert (td.read_bw, td.write_bw, td.fixed_latency_s, td.queue_depth) == (
        jd.read_bw, jd.write_bw, jd.fixed_latency_s, jd.queue_depth)
    jq = jdevices.make_queues([name])[name]
    tq = devices.make_queues([name])[name]
    assert type(tq.device).__name__ == type(jq.device).__name__
    rng = np.random.default_rng(len(name))
    for i in range(24):
        nb, now, ops_ = int(rng.integers(1, 1 << 20)), i * 2e-6, int(rng.integers(1, 5))
        assert tq.submit(nb, now=now, write=bool(i % 2), ops=ops_) == jq.submit(
            nb, now=now, write=bool(i % 2), ops=ops_)
    assert (tq.busy_s, tq.queue_wait_s, tq.bytes_total, tq.ops) == (
        jq.busy_s, jq.queue_wait_s, jq.bytes_total, jq.ops)
    for dev_t, dev_j in ((devices.adaptive_devices({name: tq}), jdevices.adaptive_devices(
            {name: jq})),):
        assert set(dev_t) == set(dev_j)
        for n in dev_t:
            for nominal, wire in ((1000.0, 600.0), (500.0, 500.0)):
                dev_t[n].observe(nominal, wire)
                dev_j[n].observe(nominal, wire)
                assert dev_t[n].commit_window() == dev_j[n].commit_window()
            assert dev_t[n].batch_service_time_s(4096, ops=2) == dev_j[n].batch_service_time_s(
                4096, ops=2)


# ---------------------------------------------------------------------------
# fault plans: seeded construction and RNG-free replay
# ---------------------------------------------------------------------------


def _plan_answers(plan, device, windows):
    return [(plan.down(device, w), plan.stall_s(device, w), plan.bw_scale(device, w),
             plan.transient_attempts(device, w), plan.corrupt_payloads(device, w))
            for w in range(windows)]


@pytest.mark.parametrize("seed", [0, 3, 17, 2**31 - 1])
def test_seeded_storm_replays_the_reference_schedule(seed):
    windows = 8 + seed % 23
    t = faults.FaultPlan.seeded_storm("cxl_hw", seed=seed, windows=windows)
    j = jfaults.FaultPlan.seeded_storm("cxl_hw", seed=seed, windows=windows)
    assert [tuple(vars(e).values()) for e in t.events] == [
        tuple(vars(e).values()) for e in j.events]
    assert _plan_answers(t, "cxl_hw", windows) == _plan_answers(j, "cxl_hw", windows)
    # Replay is RNG-free: the reverse order gives the same answers.
    rev = [_plan_answers(t, "cxl_hw", windows)[w] for w in reversed(range(windows))]
    assert rev[::-1] == _plan_answers(t, "cxl_hw", windows)
    for dev in ("hbm", "cxl_hw"):
        dt, dj = faults.default_plan(dev, 9), jfaults.default_plan(dev, 9)
        assert [tuple(vars(e).values()) for e in dt.events] == [
            tuple(vars(e).values()) for e in dj.events]
    with pytest.raises(ValueError):
        faults.FaultEvent("meteor", "hbm", 1)
    assert faults.MAX_STAGE_RETRIES == jfaults.MAX_STAGE_RETRIES


def test_faulty_device_matches_reference():
    name = "host_dram_pcie"
    plan_args = [("stall", name, 1, -1, 5e-6, 1.0, 0), ("brownout", name, 2, -1, 0.0, 0.5, 0),
                 ("transient", name, 3, -1, 0.0, 1.0, 1), ("corrupt", name, 3, -1, 0.0, 1.0, 0),
                 ("down", name, 4, -1, 0.0, 1.0, 0)]
    td = faults.FaultyMediaDevice(devices.get(name), faults.FaultPlan(
        [faults.FaultEvent(*a) for a in plan_args]))
    jd = jfaults.FaultyMediaDevice(jdevices.get(name), jfaults.FaultPlan(
        [jfaults.FaultEvent(*a) for a in plan_args]))
    for w in range(6):
        td.note_window(w)
        jd.note_window(w)
        assert td.batch_service_time_s(1 << 20, ops=4) == jd.batch_service_time_s(1 << 20, ops=4)
        assert [td.next_stage_attempt() for _ in range(3)] == [
            jd.next_stage_attempt() for _ in range(3)]
        assert [td.next_staged_payload() for _ in range(2)] == [
            jd.next_staged_payload() for _ in range(2)]
        assert td.down_now() == jd.down_now()


@pytest.mark.parametrize("name", sorted(jdevices.DEVICES))
def test_service_times_and_utilization_match_reference(name):
    """The single-op ``service_time_s`` of the plain, adaptive and faulty
    devices, and ``MediaQueue.utilization``."""
    plan_args = [("stall", name, 1, -1, 5e-6, 1.0, 0), ("brownout", name, 2, -1, 0.0, 0.5, 0)]
    tq, jq = devices.make_queues([name])[name], jdevices.make_queues([name])[name]
    pairs = [(devices.get(name), jdevices.get(name)), (tq.device, jq.device),
             (faults.FaultyMediaDevice(tq.device, faults.FaultPlan(
                 [faults.FaultEvent(*a) for a in plan_args])),
              jfaults.FaultyMediaDevice(jq.device, jfaults.FaultPlan(
                  [jfaults.FaultEvent(*a) for a in plan_args])))]
    for w in range(4):
        pairs[2][0].note_window(w)
        pairs[2][1].note_window(w)
        for td, jd in pairs:
            for nb, write in ((4096, False), (1 << 20, True), (0, False)):
                assert td.service_time_s(nb, write=write) == jd.service_time_s(nb, write=write)
    for i in range(6):
        tq.submit(1 << (10 + i), now=i * 1e-5, write=bool(i % 2))
        jq.submit(1 << (10 + i), now=i * 1e-5, write=bool(i % 2))
        for elapsed in (0.0, 1e-5 * (i + 1), 1.0):
            assert tq.utilization(elapsed) == jq.utilization(elapsed)


# ---------------------------------------------------------------------------
# the port's async pipeline vs the port's serial executor
# ---------------------------------------------------------------------------


def make_cache(async_migration=False, ring_slots=64, warm_frac=0.5, alpha=0.5,
               prefetch=False, fault_plan=None):
    return TieredKVCache(CFG, 2, 2, 8, 64, 16, ManagerConfig(policy="analytical", alpha=alpha),
                         warm_frac=warm_frac, async_migration=async_migration,
                         ring_slots=ring_slots, prefetch=prefetch, prefetch_max_pages=16,
                         fault_plan=fault_plan, device="cpu")


def fill_cache(cache, rng, n_pages):
    coords = [(la, sl, pg) for la in range(cache.la) for sl in range(cache.bs)
              for pg in range(cache.max_pages)][:n_pages]
    k = rng.normal(0, 1, (len(coords), cache.pt, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (len(coords), cache.pt, 2, 16)).astype(np.float32)
    cache.append_pages(coords, torch.from_numpy(k), torch.from_numpy(v))


def _content(cache):
    out = {}
    for rid in np.where(cache._page_exists)[0]:
        rid = int(rid)
        level = int(cache.physical[rid])
        layer = rid // (cache.bs * cache.max_pages)
        if level in (WARM, COLD):
            cls = cache._cls["warm" if level == WARM else "cold"]
            ps = int(cache._pool_slot[rid])
            item = [getattr(cache.state, f"{cls}_{f}")[layer, ps].numpy()
                    for f in ("k", "k_scales", "v", "v_scales")]
        else:
            item = cache.host_pages[rid]
        out[rid] = (level, *(np.asarray(x) for x in item))
    return out


def assert_same_state(a, b):
    np.testing.assert_array_equal(a.physical, b.physical)
    np.testing.assert_array_equal(a.manager.placement, b.manager.placement)
    ca, cb = _content(a), _content(b)
    assert ca.keys() == cb.keys()
    for rid in ca:
        assert ca[rid][0] == cb[rid][0], rid
        for i in (1, 3):
            np.testing.assert_array_equal(ca[rid][i], cb[rid][i], err_msg=f"rid {rid}")
        for i in (2, 4):
            np.testing.assert_allclose(ca[rid][i], cb[rid][i], rtol=1e-6, err_msg=f"rid {rid}")
    assert set(a.host_pages) == set(b.host_pages)
    for f in ("warm_n", "cold_n", "host_n"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    # Sentinel slots follow execution order; each page's centroid must agree.
    rids = np.array(sorted(a.host_pages), np.int64)
    layers = rids // (a.bs * a.max_pages)
    assert torch.equal(a.state.host_summary[layers, a._host_slot[rids]],
                       b.state.host_summary[layers, b._host_slot[rids]])


@pytest.mark.parametrize("seed", range(4))
def test_async_pipeline_matches_serial_executor(seed):
    """tests/test_media.py:120 on the port: random plans through the serial
    ``migrate_batch`` and through the pipeline (a small ring, so cohorts
    chunk and stall) land byte-identical state."""
    rng = np.random.default_rng(seed)
    serial, asyn = make_cache(), make_cache(async_migration=True, ring_slots=8)
    n_pages = int(rng.integers(6, serial.n_regions + 1))
    fill_seed = int(rng.integers(0, 2**31 - 1))
    fill_cache(serial, np.random.default_rng(fill_seed), n_pages)
    fill_cache(asyn, np.random.default_rng(fill_seed), n_pages)
    for _ in range(int(rng.integers(1, 4))):
        live = np.where(serial._page_exists)[0]
        rids = rng.choice(live, size=int(rng.integers(1, len(live) + 1)), replace=False)
        dsts = np.array([rng.choice([t for t in (WARM, COLD, HOST8, HOST4)
                                     if t != serial.physical[r]]) for r in rids], np.int64)
        serial.migrate_batch(rids, dsts)
        queued = asyn.pipeline.submit(asyn.plan_cohorts(rids, dsts))
        ticks = 0
        while asyn.pipeline.busy:
            asyn.pipeline.tick()
            ticks += 1
            assert ticks < 10 * queued + 50, "pipeline wedged"
        assert_same_state(serial, asyn)
    ring = asyn.staging_ring
    assert ring.held_slots == 0 and ring.free_slots == ring.n_slots


def test_window_boundary_is_non_blocking():
    c = make_cache(async_migration=True, ring_slots=8, warm_frac=1.0)
    fill_cache(c, np.random.default_rng(7), 24)
    counts = np.zeros(c.n_regions)
    counts[np.where(c._page_exists)[0][:4]] = 1000.0
    c.manager.record_access_counts(counts)
    _, queued = c.end_window()
    assert queued > 0 and c.pipeline.busy
    c.pipeline.tick()
    assert (c.physical == INFLIGHT).any()
    ticks = 0
    while c.pipeline.busy:
        c.pipeline.tick()
        ticks += 1
    assert ticks > 1 and not (c.physical == INFLIGHT).any()
    s = make_cache(warm_frac=1.0)
    fill_cache(s, np.random.default_rng(7), 24)
    s.manager.record_access_counts(counts.copy())
    s.end_window()
    assert_same_state(s, c)


def _window(c, counts, ticks=8):
    c.manager.record_access_counts(counts)
    for _ in range(ticks):
        if c.pipeline.busy:
            c.pipeline.tick()
        else:
            c.prefetch_tick()
    c.end_window()
    c.drain_migrations()


def test_prefetch_hit_commits_what_the_oracle_commits():
    """tests/test_prefetch.py's hit path on the port: the warming host set
    is staged mid-window, claimed at the boundary, and the promotions land
    byte-identical to a prefetch-free run, with less boundary read time."""
    spec, oracle = (make_cache(async_migration=True, warm_frac=1.0, prefetch=p)
                    for p in (True, False))
    for c in (spec, oracle):
        fill_cache(c, np.random.default_rng(5), 24)
        live = np.where(c._page_exists)[0]
        device, host = live[:12], live[12:]
        c.migrate_batch(host, np.full(host.size, HOST4, np.int64))
    for hot_host in (0.0, 800.0):
        for c in (spec, oracle):
            counts = np.zeros(c.n_regions)
            counts[device] = 500.0
            counts[host] = hot_host
            _window(c, counts)
    p = spec.pipeline
    assert p.prefetch_staged == p.prefetch_hits == len(host) and p.prefetch_misses == 0
    assert (spec.physical[host] != HOST4).all()
    assert_same_state(spec, oracle)
    assert p.demand_swapin_s < oracle.pipeline.demand_swapin_s and p.prefetch_bytes > 0
    assert spec.staging_ring.free_slots == spec.staging_ring.n_slots


def test_storm_gives_the_same_placements_in_both_modes():
    """A seeded storm (stall, brownout, down, transients, corruptions) on the
    host device: serial and async land the same placements and defer the
    same moves; every corruption is detected and repaired from the pristine
    copy; no ring credit leaks."""
    plan = faults.FaultPlan.seeded_storm("host_dram_pcie", seed=1, windows=8)
    soft = faults.FaultPlan([faults.FaultEvent(k, d, 1, 99) for k in ("transient", "corrupt")
                             for d in ("hbm", "host_dram_pcie")])
    merged = faults.FaultPlan(plan.events + soft.events)
    runs = []
    for is_async in (False, True):
        c = make_cache(async_migration=is_async, ring_slots=8, fault_plan=merged, alpha=0.0)
        fill_cache(c, np.random.default_rng(3), 24)
        for w in range(7):
            counts = np.zeros(c.n_regions)
            live = np.where(c._page_exists)[0]
            counts[live[w % 4::4]] = 500.0
            c.manager.record_access_counts(counts)
            c.end_window()
            c.drain_migrations()
        runs.append(c)
    serial, asyn = runs
    np.testing.assert_array_equal(serial.physical, asyn.physical)
    assert serial.fault_deferred_pages == asyn.fault_deferred_pages
    p = asyn.pipeline
    assert p.fault_retries > 0 and p.corruptions_injected > 0
    assert p.corruptions_detected == p.corruptions_injected == p.corruptions_repaired
    assert asyn.staging_ring.held_slots == 0
