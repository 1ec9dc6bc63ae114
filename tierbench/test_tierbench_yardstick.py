"""The benchmark's yardstick on the CPU: the traffic generator, the
percentiles, the TCO aggregate and the operation and byte counts."""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tierbench import counts, harness, tco, traffic  # noqa: E402
from tierbench.families import dense  # noqa: E402

MIX = {"name": "t", "arrivals": {"kind": "poisson"},
       "prompt_tokens": {"dist": "lognormal", "median": 768, "sigma": 0.3, "min": 512, "max": 1280},
       "output_tokens": {"dist": "lognormal", "median": 64, "sigma": 0.5, "min": 32, "max": 128}}
# The port's qwen1_5_4b SMOKE shapes.
SMOKE = {"family": "dense", "hidden_size": 64, "intermediate_size": 160,
         "num_attention_heads": 4, "num_key_value_heads": 4, "num_hidden_layers": 2,
         "vocab_size": 256, "head_dim": 16, "attention_bias": True, "qk_norm": False}


def _key(s):
    return [(a.due, a.max_new_tokens, a.prompt.tobytes()) for a in s]


def test_schedule_is_the_seeds_and_only_the_seeds():
    a = traffic.schedule(MIX, 2.0, 30.0, 2**31 + 17, 151936, 1536)
    b = traffic.schedule(MIX, 2.0, 30.0, 2**31 + 17, 151936, 1536)
    c = traffic.schedule(MIX, 2.0, 30.0, 2**31 + 18, 151936, 1536)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)
    # Another seed draws other arrivals, sizes and tokens ...
    assert [x.due for x in a] != [x.due for x in c]
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in c]
    assert [x.max_new_tokens for x in a] != [x.max_new_tokens for x in c]
    # ... from the same set: the same work in another order.
    assert sorted(len(x.prompt) for x in a) == sorted(len(x.prompt) for x in c)
    assert sorted(x.max_new_tokens for x in a) == sorted(x.max_new_tokens for x in c)
    assert a[-1].due == pytest.approx(c[-1].due, rel=1e-12)
    assert len(a) == traffic.request_count(2.0, 30.0)
    assert all(512 <= len(x.prompt) <= 1280 and 32 <= x.max_new_tokens <= 128 for x in a)
    assert all(0 <= x.prompt.min() and x.prompt.max() < 151936 for x in a)


def test_sizes_and_gaps_are_the_quantiles():
    s = traffic.schedule(MIX, 2.0, 30.0, 3, 151936, 1536)
    n = len(s)
    assert sorted(len(x.prompt) for x in s) == \
        traffic.length_quantiles(MIX["prompt_tokens"], n).tolist()
    gaps = np.diff([0.0] + [x.due for x in s]) * 2.0
    np.testing.assert_allclose(np.sort(gaps), traffic.unit_gaps(n), rtol=1e-9)


def test_schedule_refuses_what_no_mix_uses():
    with pytest.raises(ValueError):
        traffic.schedule(dict(MIX, arrivals={"kind": "burst"}), 2.0, 30.0, 1, 1000, 1536)
    with pytest.raises(ValueError):
        traffic.length_quantiles({"dist": "uniform", "min": 1, "max": 9}, 4)


def test_schedule_refuses_requests_longer_than_the_cache():
    with pytest.raises(ValueError):
        traffic.schedule(MIX, 2.0, 30.0, 1, 1000, 1024)


class _Arr:
    def __init__(self, idx, due):
        self.idx, self.due = idx, due


class _Rec:
    def __init__(self, idx, due, times):
        self.arrival = _Arr(idx, due)
        self.times = times


class _Drv:
    t0 = 0.0


def test_backlog_counts_the_due_not_yet_started():
    drv = harness.Driver.__new__(harness.Driver)
    drv.t0 = 10.0
    drv.arrivals = [_Arr(0, 0.5), _Arr(1, 1.0), _Arr(2, 2.0), _Arr(3, 5.0)]
    drv.recs = [_Rec(0, 0.5, [10.7, 10.9]), _Rec(1, 1.0, [12.5])]
    assert drv.backlog(10.2) == 0
    assert drv.backlog(11.0) == 1  # request 1 due, not started
    assert drv.backlog(12.1) == 2  # requests 1 and 2
    assert drv.backlog(13.0) == 1  # request 1 started at 12.5
    assert drv.backlog(16.0) == 2


def test_percentiles_take_every_sample():
    drv = _Drv()
    # Request 0 due at 1.0: first token at 1.5, then tokens 0.1 s apart;
    # request 1 due at 2.0 never started; request 2 due before the window.
    drv.arrivals = [_Arr(0, 1.0), _Arr(1, 2.0), _Arr(2, 0.2)]
    drv.recs = [_Rec(0, 1.0, [1.5, 1.6, 1.7, 2.7]), _Rec(2, 0.2, [0.4, 1.2])]
    drv.boundaries = [(1.5, 30.0, 100.0), (2.5, 10.0, 100.0), (9.0, 1.0, 1.0)]
    e = harness.end_to_end(drv, 1.0, 3.0)
    # TTFT samples: 0.5 and (window end - due) 1.0 for the one never served.
    assert e["_attempted"] == 2
    assert e["ttft_p95_ms"] == pytest.approx(np.percentile([0.5, 1.0], 95) * 1e3)
    # Gaps ending in the window: 0.8 (request 2), 0.1, 0.1, 1.0 (request 0).
    assert e["_tokens_in_window"] == 4
    assert e["tpot_p95_ms"] == pytest.approx(np.percentile([0.8, 0.1, 0.1, 1.0], 95) * 1e3)
    assert e["tco_savings_pct"] == pytest.approx(100.0 * (1 - 40.0 / 200.0))
    assert harness.percentile(list(range(101)), 95) == 95.0


def test_tco_matches_a_hand_count_at_smoke_shapes():
    # A page of 16 tokens x 4 KV heads x 16 dims, K and V: 2048 elements.
    costs = tco.level_costs(2048)
    gib = float(1 << 30)
    # Level 0: 4096 bf16 bytes; C5 slab int8: one 2048-byte slot at 85%
    # fill plus 16 f32 scales; C9 packed int4 1024 + 128 -> 1152 + 8; C7
    # packed int8 2048 + 64 -> 2176 + 8 on the host; C10 as C9 on the host.
    hand = np.array([4096 * 10, (int(2048 / 0.85) + 64) * 10, 1160 * 10, 2184 * 10 / 3,
                     1160 * 10 / 3]) / gib
    np.testing.assert_allclose(costs, hand, rtol=1e-12)
    cost, mx = tco.placement_cost(np.array([1, 2, 3, 4]), costs)
    assert mx == pytest.approx(4 * 4096 * 10 / gib)
    assert tco.savings_pct(cost, mx) == pytest.approx(
        100 * (1 - (2473 * 10 + 1160 * 10 + (2184 + 1160) * 10 / 3) / (4 * 40960)))


def test_tco_table_is_the_ports_at_smoke_shapes():
    from repro_torch.core import tco as ptco
    from repro_torch.serving.kv_cache import kv_tierset

    ts = kv_tierset(2048)
    np.testing.assert_allclose(tco.level_costs(2048), ptco.usd_per_region(ts, 4096), rtol=1e-12)


def test_counts_match_hand_counts_at_smoke_shapes():
    lin = 64 * 12 * 16 + 4 * 16 * 64 + 3 * 64 * 160
    assert dense.linear_params(dense.dims(SMOKE)) == lin == 47104
    wb = 2 * (lin * 2 + 2 * 64 * 4 + 12 * 16 * 2) + 64 * 4 + 64 * 256 * 2
    assert dense.weight_bytes(SMOKE) == wb == 223232
    flops, nbytes = dense.prefill(SMOKE, 10)
    assert flops == 2 * 10 * 2 * lin + 2 * 4 * 4 * 16 * 55 + 2 * 64 * 256
    assert nbytes == wb + 10 * 64 * 2
    m = dense.shape(SMOKE)
    assert (m.layers, m.heads, m.kv, m.hd) == (2, 4, 4, 16)
    assert counts.page_bytes(m, 16, 8) == 2 * 16 * 4 * (16 + 4)
    assert counts.page_bytes(m, 16, 4) == 2 * 16 * 4 * (8 + 4)
    flops, nbytes = dense.decode_step(SMOKE, 2, 100, 5000)
    assert flops == 2 * 2 * (2 * lin + 64 * 256) + 4 * 4 * 16 * 100
    assert nbytes == wb + 2 * 64 * 2 + 5000
    # One slot, per layer 3 warm, 1 cold, 2 host pages and 20 recent rows.
    got = counts.attention_step_bytes(m, 16, 8, 4, np.array([[3], [3]]), np.array([[1], [1]]),
                                      np.array([[2], [2]]), np.array([20]))
    q_out = 2 * (4 * 16 * 2 + 4 + 2 * 20 * 4 * 16 * 2) + 2 * (4 * 16 * 4 + 2 * 4 * 4)
    pages = 6 * 2 * 16 * 4 * 20 + 2 * 2 * 16 * 4 * 12 + 4 * 4 * 16 * 4
    rows = 12 * 2 * 4 + 12 * 2 * 4
    assert got == q_out + pages + rows
    assert counts.quant_bytes(m, 16, 3, 8) == 3 * (2 * 16 * 4 * 16 * 2 + 2 * 16 * 4 * 20)


def test_weights_are_the_seeds_norms_included():
    import torch

    from tierbench import weights

    conf = dict(SMOKE, qk_norm=True)
    a, b, c = (weights.make(conf, s, "cpu") for s in (2**31 + 3, 2**31 + 3, 4))
    for path in (("final_norm",), ("blocks", "norm1"), ("blocks", "norm2"),
                 ("blocks", "attn", "q_norm"), ("blocks", "attn", "k_norm"),
                 ("blocks", "attn", "wq"), ("blocks", "ffn", "w_down")):
        x, y, z = a, b, c
        for k in path:
            x, y, z = x[k], y[k], z[k]
        assert torch.equal(x, y) and not torch.equal(x, z), path
    norm = a["blocks"]["norm1"]
    assert norm.dtype == torch.float32 and not torch.all(norm == 1)
    assert abs(float(norm.mean()) - 1) < 0.05 and 0.05 < float(norm.std()) < 0.15
