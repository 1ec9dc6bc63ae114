"""The recent rows a decode step reads, as ``decode_mfu_pct`` and
``attn_roofline_pct`` count them (``harness.recent_rows``), where a window
layer has released its older pages: placement level 0 below pages that
another layer still holds.

A hand count on made-up placements, with warm, cold, host and in-flight
pages, a slot that holds no page and an idle slot; and a pin: on placements
without such gaps (each active slot's layers all hold its pages 0..n-1, as
the engine pages every layer out at once), drawn from several seeds and
taken from a CPU run of the engine, both readers read exactly what the
formulas they had before read."""

import copy
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tierbench import counts, families, harness, peaks, trace  # noqa: E402
from tierbench.harness import COLD, HOST4, HOST8, INFLIGHT, WARM  # noqa: E402
from tierbench.metrics import attn_roofline_pct, decode_mfu_pct  # noqa: E402
from tierbench.test_tierbench_check import SMALL  # noqa: E402
from tierbench.test_tierbench_check import run as small_run  # noqa: E402

W, C, H8, H4, F = WARM, COLD, HOST8, HOST4, INFLIGHT
BASE = 100  # engine steps before the first recorded one
# Two steps of a cache of 3 layers x 4 slots x 6 pages of 16 tokens. Layer 0
# is a window layer that has released its oldest pages; layers 1-2 hold
# every page. Slot 1 holds no page yet; slot 2 is idle (its pages are not
# read). At the second step slot 3's last page is held only in flight or on
# the host.
STEPS = [
    dict(slots=[0, 1, 3], totals=[40, 20, 106], levels={
        0: [[W, W], [C, W], [W, H8]],
        2: [[C, C, C, C], [C, C, C, C], [C, C, C, C]],
        3: [[0, 0, 0, W, F, C], [H8, C, W, W, C, F], [H4, H8, C, W, W, W]]}),
    dict(slots=[3], totals=[107], levels={
        2: [[C, C, C, C], [C, C, C, C], [C, C, C, C]],
        3: [[0, 0, 0, 0, C, F], [H8, C, W, W, C, F], [H4, H8, C, W, W, H8]]}),
]
# By hand, at the small shape (KV 2, hd 64: an int8 page 4352 B, an int4 page
# 2304 B, a recent row 512 B a layer). Recent rows: the tokens after the
# last page any layer holds, and the new one: 40 - 2*16 + 1, 20 + 1,
# 106 - 6*16 + 1; then 107 - 6*16 + 1.
RECENT = [[9, 21, 11], [12]]
N_WARM = [[[2, 0, 1], [1, 0, 2], [1, 0, 3]], [[0], [2], [2]]]
N_COLD = [[[0, 0, 1], [1, 0, 2], [0, 0, 1]], [[1], [2], [1]]]
N_HOST = [[[0, 0, 0], [0, 0, 1], [1, 0, 2]], [[0], [1], [3]]]
# Keys: device pages x 16 + 3 layers x recent rows; bytes: 4352 per warm
# page, 2304 per cold one, 512 per recent row and layer.
KEYS = [15 * 16 + 3 * 41, 8 * 16 + 3 * 12]
KV_BYTES = [10 * 4352 + 5 * 2304 + 123 * 512, 4 * 4352 + 4 * 2304 + 36 * 512]
# counts.attention_step_bytes: q, window lengths and recent rows per layer,
# device pages, host sentinels, table entries, out with m and l, page masses.
ATTN_BYTES = [3 * (3 * 512 + 12 + 2 * 41 * 256) + 43520 + 11520 + 4 * 512 + 19 * 8
              + 3 * 3 * 1056 + 19 * 8,
              3 * (512 + 4 + 2 * 12 * 256) + 17408 + 9216 + 4 * 512 + 12 * 8
              + 3 * 1056 + 12 * 8]
KERNEL_S, DECODE_S = 2.5e-6, 1.5e-3


def small_conf(name="qwen3_32b"):
    c = copy.deepcopy(harness.load_json(harness.HERE / "configs" / f"{name}.json"))
    c.update(SMALL)
    return c


def fake_res(conf, snaps, step_slots):
    """What the readers take of a ``harness.Result``: placements before each
    step, the active slots and their tokens, the engine's decode clock over
    the window and the attention kernel's device time over the slice."""
    steps = (BASE, BASE + len(snaps))
    drv = types.SimpleNamespace(base=BASE, shape=snaps[0].shape, step_slots=step_slots,
                                levels_at=lambda k: snaps[k - BASE])
    tr = types.SimpleNamespace(kernel_seconds=lambda name: (KERNEL_S, 7))
    return types.SimpleNamespace(cell=types.SimpleNamespace(conf=conf), drv=drv, trace=tr,
                                 slice_steps=steps, window_steps=steps,
                                 stats_open={"decode_s": 0.0}, stats_close={"decode_s": DECODE_S})


def hand_placements():
    snaps, step_slots = [], []
    for s in STEPS:
        lv = np.zeros((3, 4, 6), np.int8)
        for slot, rows in s["levels"].items():
            for layer, row in enumerate(rows):
                lv[layer, slot, :len(row)] = row
        snaps.append(lv)
        step_slots.append((np.array(s["slots"]), np.array(s["totals"]), ()))
    return snaps, step_slots


def test_released_pages_count_as_a_hand_count(monkeypatch):
    conf = small_conf()
    snaps, step_slots = hand_placements()
    res = fake_res(conf, snaps, step_slots)
    for k, (slots, totals, _) in enumerate(step_slots):
        got = harness.recent_rows(snaps[k][:, slots], totals, 16)
        assert got.tolist() == RECENT[k]

    fam = families.of(conf)
    decode_step, step_bytes = fam.decode_step, counts.attention_step_bytes
    seen_decode, seen_attn = [], []

    def spy_decode(conf_, slots, keys, kv_bytes):
        seen_decode.append((slots, keys, kv_bytes))
        return decode_step(conf_, slots, keys, kv_bytes)

    def spy_attn(m, pt, wb, cb, n_warm, n_cold, n_host, recent):
        seen_attn.append((n_warm.tolist(), n_cold.tolist(), n_host.tolist(), recent.tolist()))
        out = step_bytes(m, pt, wb, cb, n_warm, n_cold, n_host, recent)
        assert out == ATTN_BYTES[len(seen_attn) - 1]
        return out

    monkeypatch.setattr(fam, "decode_step", spy_decode)
    monkeypatch.setattr(counts, "attention_step_bytes", spy_attn)
    least = [harness.decode_least_s(res, BASE + k, s, t)
             for k, (s, t, _) in enumerate(step_slots)]
    assert seen_decode == [(4, KEYS[k], KV_BYTES[k]) for k in range(2)]
    assert least == [peaks.least_time_s(*decode_step(conf, 4, KEYS[k], KV_BYTES[k]))
                     for k in range(2)]
    assert decode_mfu_pct.read(res) == 100.0 * (least[0] + least[1]) / DECODE_S
    got = attn_roofline_pct.read(res)
    assert seen_attn == [(N_WARM[k], N_COLD[k], N_HOST[k], RECENT[k]) for k in range(2)]
    assert got == 100.0 * sum(ATTN_BYTES) / peaks.HBM_BYTES_PER_S / KERNEL_S


# --------------------------------------------------- the readers before
def before_decode_least_s(res, step, slots, totals):
    conf = res.cell.conf
    fam = families.of(conf)
    m = fam.shape(conf)
    t = conf["tiering"]
    pt = int(t["page_tokens"])
    lv = res.drv.levels_at(step)[:, slots]  # [layers, active, pages]
    warm = (lv == WARM).sum(-1)
    cold = (lv == COLD).sum(-1)
    paged = (lv != 0).sum(-1)
    recent = totals[None] - paged * pt + 1  # [layers, active]
    keys = int((warm + cold).sum()) * pt + int(recent.sum())
    kv_bytes = (int(warm.sum()) * counts.page_bytes(m, pt, int(t["warm_bits"]))
                + int(cold.sum()) * counts.page_bytes(m, pt, int(t["cold_bits"]))
                + int(recent.sum()) * 2 * m.kv * m.hd * counts.BF16)
    flops, nbytes = fam.decode_step(conf, res.drv.shape[1], keys, kv_bytes)
    return peaks.least_time_s(flops, nbytes)


def before_decode_mfu_pct(res):
    took = harness.stat_delta(res, "decode_s")
    first, last = res.window_steps
    if last <= first or took <= 0:
        return None
    drv = res.drv
    least = 0.0
    for k in range(first, last):
        slots, totals, _ = drv.step_slots[k - drv.base]
        least += before_decode_least_s(res, k, slots, totals)
    return 100.0 * least / took


def before_attn_roofline_pct(res):
    tr = res.trace
    if tr is None:
        return None
    secs, launches = tr.kernel_seconds(trace.ATTENTION)
    if launches == 0 or secs <= 0:
        return None
    conf = res.cell.conf
    m = families.of(conf).shape(conf)
    t = conf["tiering"]
    pt = int(t["page_tokens"])
    drv = res.drv
    total = 0
    for k in range(*res.slice_steps):
        slots, totals, _ = drv.step_slots[k - drv.base]
        lv = drv.levels_at(k)[:, slots]
        paged = (lv != 0).sum(-1)  # [layers, active], equal over layers
        total += counts.attention_step_bytes(
            m, pt, int(t["warm_bits"]), int(t["cold_bits"]), (lv == WARM).sum(-1),
            (lv == COLD).sum(-1), ((lv == HOST8) | (lv == HOST4)).sum(-1),
            (totals - paged[0] * pt + 1))
    return 100.0 * total / peaks.HBM_BYTES_PER_S / secs


def gap_free_placements(conf, slots, seed, n_steps=12):
    """Placements as the engine leaves them: each slot's layers hold its
    pages 0..n-1, each in a level of its own, and nothing after them."""
    t = conf["tiering"]
    pt = int(t["page_tokens"])
    pages = 2816 // pt  # the cells' max_seq_len
    layers = families.of(conf).shape(conf).layers
    rng = np.random.default_rng([seed, 29])
    snaps, step_slots = [], []
    for _ in range(n_steps):
        lv = np.zeros((layers, slots, pages), np.int8)
        held = rng.integers(0, pages + 1, slots)
        held[rng.random(slots) < 0.2] = 0
        for s in range(slots):
            lv[:, s, :held[s]] = rng.choice([W, C, H8, H4, F], (layers, held[s]),
                                            p=[0.4, 0.35, 0.1, 0.05, 0.1])
        active = np.flatnonzero(rng.random(slots) < 0.75)
        if active.size == 0:
            active = np.array([0])
        totals = held[active] * pt + rng.integers(0, 2 * pt, active.size)
        snaps.append(lv)
        step_slots.append((active, totals, ()))
    return snaps, step_slots


@pytest.mark.parametrize("name,slots", [("qwen1_5_4b", 2), ("qwen3_32b", 6)])
@pytest.mark.parametrize("seed", [2**31 + 29, 3, 4])
def test_gap_free_placements_read_as_before(name, slots, seed):
    conf = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    res = fake_res(conf, *gap_free_placements(conf, slots, seed))
    for k, (s, t, _) in enumerate(res.drv.step_slots):
        assert harness.decode_least_s(res, BASE + k, s, t) == \
            before_decode_least_s(res, BASE + k, s, t)
    assert decode_mfu_pct.read(res) == before_decode_mfu_pct(res)
    assert attn_roofline_pct.read(res) == before_attn_roofline_pct(res)


def test_the_engines_placements_read_as_before():
    """A CPU run of the engine at a small width: every step of the run, and
    its window and traced slice, read as before. On one thread: on the CPU,
    more threads make a run this small many times slower."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = small_run(2**31 + 7, trace=True)
    finally:
        torch.set_num_threads(n_threads)
    drv = res.drv
    first, last = drv.base, drv.base + len(drv.step_slots)
    for k in range(first, last):
        slots, totals, _ = drv.step_slots[k - drv.base]
        held = drv.levels_at(k)[:, slots] != 0
        n = held.sum(-1)
        assert (n == n[:1]).all() and all(held[i, j, :n[i, j]].all()
                                          for i in range(n.shape[0]) for j in range(n.shape[1]))
        assert harness.decode_least_s(res, k, slots, totals) == \
            before_decode_least_s(res, k, slots, totals)
    assert decode_mfu_pct.read(res) == before_decode_mfu_pct(res) > 0
    res.trace = types.SimpleNamespace(kernel_seconds=lambda name: (KERNEL_S, 7))
    assert res.slice_steps[1] > res.slice_steps[0]
    assert attn_roofline_pct.read(res) == before_attn_roofline_pct(res) > 0
