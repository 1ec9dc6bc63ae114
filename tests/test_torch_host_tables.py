"""The cache's host page tables (``kv_cache._TableEditor``) against the
device copies they are uploaded to, on the CPU.

The host arrays are the tables' source: every edit is made there, each entry
beside the region id (rid) it holds, and ``commit`` uploads them. A seeded
random sequence drives a small cache through every path that edits a table:
batched page-in with warm eviction, the per-page ingestion path, serial
migration batches to all four levels, async cohorts staged and committed
over ticks, prefetch's claims and discards at tier-window boundaries, slot
release, and a preemption's park and restore. After every commit, and after
every call, the host tables and counts must equal the device's, every entry
below a count must hold a rid of its own (layer, slot) row that maps back to
the entry's pool row through ``_pool_slot`` (the host table: through
``_host_slot``), every entry past it none (-1), and ``cache.table_uploads``
must have one record per commit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.manager import ManagerConfig  # noqa: E402
from repro_torch.serving import kv_cache as kvc  # noqa: E402

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=128, head_dim=16)
KV, HD, T = TINY["n_kv_heads"], TINY["head_dim"], 8
LEVELS = (kvc.WARM, kvc.COLD, kvc.HOST8, kvc.HOST4)
POOLS = ("warm", "cold", "host")


def uploads(cache):
    return sum(r[4] for r in cache.tracer.records(0, 1) if r[0] == "cache.table_uploads")


def check_mirror(cache, state):
    tab = cache._tables
    per_row = cache.bs * cache.max_pages
    for p in POOLS:
        np.testing.assert_array_equal(getattr(state, f"{p}_table").numpy(), tab.tables[p],
                                      err_msg=p)
        np.testing.assert_array_equal(getattr(state, f"{p}_n").numpy(), tab.counts[p],
                                      err_msg=p)
        slot_of = cache._host_slot if p == "host" else cache._pool_slot
        valid = np.arange(tab.tables[p].shape[2]) < tab.counts[p][..., None]
        la, sl, _ = np.nonzero(valid)
        rids = tab.rids[p][valid]
        assert (rids >= 0).all() and (tab.rids[p][~valid] == -1).all(), p
        np.testing.assert_array_equal(rids // per_row, la, err_msg=p)
        np.testing.assert_array_equal((rids // cache.max_pages) % cache.bs, sl, err_msg=p)
        np.testing.assert_array_equal(slot_of[rids], tab.tables[p][valid], err_msg=p)


class Mirror:
    """A cache whose every commit is checked, and counted."""

    def __init__(self, pool_bits):
        self.c = kvc.TieredKVCache(
            ModelConfig(**TINY), 2, 3, T, 64, 16,
            ManagerConfig(policy="analytical", alpha=0.5, window_steps=8), warm_frac=0.25,
            async_migration=True, prefetch=True, pool_bits=pool_bits, device="cpu")
        self.commits = 0
        commit = self.c._tables.commit

        def checked(state):
            new = commit(state)
            self.commits += 1
            check_mirror(self.c, new)
            assert uploads(self.c) == self.commits
            return new

        self.c._tables.commit = checked

    def check(self):
        check_mirror(self.c, self.c.state)
        assert uploads(self.c) == self.commits

    def pages(self, rng, entries):
        k = torch.from_numpy(rng.normal(0, 1, (len(entries), T, KV, HD)).astype(np.float32))
        return k, k * 0.5

    def append(self, rng, slot, pages):
        entries = [(la, slot, pg) for la in range(self.c.la) for pg in pages]
        self.c.append_pages(entries, *self.pages(rng, entries))
        self.check()

    def step(self, telemetry, boost):
        """One decode step's cache work: the fold, a pipeline or prefetch
        tick; host pages warmed by ``boost``."""
        c = self.c
        c.record_telemetry(telemetry)
        host = ((c.physical == kvc.HOST8) | (c.physical == kvc.HOST4)) & c._page_exists
        c.manager.record_access_counts(boost * host)
        if c.pipeline.busy:
            c.pipeline.tick()
        else:
            c.prefetch_tick()
        self.check()


@pytest.mark.parametrize("pool_bits", [{"warm": 8, "cold": 4}, {"warm": 8, "cold": 8}],
                         ids=["w8c4", "w8c8"])
@pytest.mark.parametrize("seed", range(3))
def test_host_tables_mirror_the_device(seed, pool_bits):
    rng = np.random.default_rng(seed)
    m = Mirror(pool_bits)
    c = m.c
    shape = tuple(c.state.warm_table.shape)
    telemetry = {p: rng.random(shape, dtype=np.float32) for p in POOLS}
    empty = c._fold_telemetry(telemetry)  # no page yet: float64 zeros
    assert empty.dtype == np.float64 and not empty.any()
    # Page-in past the warm pool's 12 rows: batched demotions free room.
    for slot in range(c.bs):
        m.append(rng, slot, range(5))
    assert (c.physical == kvc.COLD).any() and c._alloc["warm"].used == c._alloc["warm"].capacity
    k, v = m.pages(rng, [0])
    c.append_page(1, 2, 5, k[0], v[0])  # the per-page path: one eviction
    m.check()
    live = np.where(c._page_exists)[0]
    c.migrate_batch(live, rng.choice(LEVELS, live.size))
    m.check()
    assert {int(x) for x in c.physical[live]} == set(LEVELS)
    # Steady masses keep the plans small, so prefetch finds idle steps; host
    # pages warm faster every step from the third window on.
    for s in range(48):
        m.step(telemetry, 50.0 * s if s >= 16 else 0.0)
        if s % 8 == 7:
            c.end_window()
            m.check()
        if s == 21:
            c.release_slot_pages(1)
            m.check()
        if s == 29:
            # The slot's next request (page-in drains first: a demotion
            # must not take pages a queued cohort holds).
            c.drain_migrations()
            m.append(rng, 1, range(3))
        if s == 33:
            orig = c.demote_slot_to_host(2)
            parked = c.park_slot(2, orig)
            m.check()
            assert c.slot_rids(2).size == 0
            assert c.restore_slot(2, parked) == len(orig)
            m.check()
    c.drain_migrations()
    m.check()
    p = c.pipeline
    assert p.pages_moved > 0 and p.prefetch_hits > 0 and p.prefetch_misses > 0
    assert m.commits > 20
