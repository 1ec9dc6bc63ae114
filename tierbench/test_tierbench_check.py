"""A CPU rehearsal of a run at a small width: the loop, the metrics and the
check against the plain reference, the float8 control failing the check,
and the check failing under faults planted under the timed path.

The runs use a virtual clock (each reading advances it by a fixed tick,
each wait by its length), so they are the same from one test run to the
next."""

import copy

import pytest

torch = pytest.importorskip("torch")

from tierbench import harness  # noqa: E402

# A small Qwen-shaped model: heads of 64, GQA 2, qk-norm off, QKV biases.
SMALL = {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
         "num_key_value_heads": 2, "num_hidden_layers": 3, "vocab_size": 2048, "head_dim": 64}
MIX = {"name": "small", "arrivals": {"kind": "poisson"},
       "prompt_tokens": {"dist": "lognormal", "median": 64, "sigma": 0.3, "min": 40, "max": 96},
       "output_tokens": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 12, "max": 40}}
# Readings at this width on seeds 20-33: the program's widest logit gap
# 0.030-0.271, its mean 0.0008-0.0041 and its mean page-mass distance
# 0.0022-0.0046; the float8 control's 0.460-0.871, 0.039-0.095 and
# 0.0141-0.0201.
LIMITS = {"logit_gap": 0.3, "mean_logit_gap": 0.02, "mean_hotness_gap": 0.009}


class VClock:
    def __init__(self, tick=0.004):
        self.t, self.tick = 0.0, tick

    def now(self):
        self.t += self.tick
        return self.t

    def sleep(self, s):
        self.t += max(s, 0.0)


def small_cell():
    cell = harness.load_cell("qwen1_5_4b-longctx")
    cell.conf = copy.deepcopy(cell.conf)
    cell.conf.update(SMALL)
    cell.mix = MIX
    cell.cell = {"batch_slots": 2, "max_seq_len": 144, "rate_rps": 6.0, "warm_s": 0.5,
                 "sample_tokens": 120, "trace_steps": 8, "limits": LIMITS}
    return cell


def run(seed, **kw):
    vc = VClock()
    return harness.run_cell(small_cell(), seed, 2.0, kw.pop("trace", False), "cpu", 0.0,
                            clock=vc.now, sleep=vc.sleep, **kw)


@pytest.mark.parametrize("seed", [2**31 + 5, 11])
def test_rehearsal_agrees_with_the_reference(seed):
    res = run(seed, trace=(seed == 11))
    e = res.e2e
    assert e["_attempted"] > 0 and e["_tokens_in_window"] > 0 and e["_boundaries"] > 0
    assert e["ttft_p95_ms"] > 0 and e["tpot_p95_ms"] > 0 and 0 < e["tco_savings_pct"] < 100
    assert res.checks["sampled_tokens_at_least"]["value"] >= 120
    assert res.correct, res.gaps
    if seed == 11:
        pl = harness.per_layer(res)
        for name in ("prefill_ms", "decode_step_ms", "prefill_mfu_pct", "decode_mfu_pct",
                     "window_ms", "daemon_ms_per_step", "overlapped_step_pct"):
            assert pl[name]["value"] > 0, name
        # No device on the CPU: the device metrics find nothing to read.
        assert "attn_roofline_pct" not in pl and "device_idle_pct" not in pl


def test_fp8_control_fails_the_check():
    res = run(3, control="fp8")
    checks = harness.check(harness.numbers(res.gaps, control=True), LIMITS, 120)
    assert res.correct and not harness.passed(checks), checks


def _state_unchanged(eng):
    step = eng._step_fn

    def fn(params, token, tkv, extra):
        logits, _, extra, tel = step(params, token, tkv, extra)
        return logits, tkv, extra, tel

    eng._step_fn = fn


def _half_batch(eng):
    step = eng._step_fn

    def fn(params, token, tkv, extra):
        logits, tkv, extra, tel = step(params, token, tkv, extra)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], logits[:half]]), tkv, extra, tel

    eng._step_fn = fn


def _token_altered(eng):
    step = eng._step_fn
    n = [0]

    def fn(params, token, tkv, extra):
        logits, tkv, extra, tel = step(params, token, tkv, extra)
        n[0] += 1
        if n[0] % 7 == 0:
            logits = logits.clone()
            logits[:, :, 5] += 1e4
        return logits, tkv, extra, tel

    eng._step_fn = fn


def _hotness_altered(eng):
    step = eng._step_fn

    def fn(params, token, tkv, extra):
        logits, tkv, extra, tel = step(params, token, tkv, extra)
        tel = dict(tel, warm=torch.roll(tel["warm"], 1, dims=-1))
        return logits, tkv, extra, tel

    eng._step_fn = fn


def _page_out_altered(eng):
    cache = eng.cache
    append = cache.append_pages

    def fn(entries, kpages, vpages):
        return append(entries, kpages.flip(1), vpages)

    cache.append_pages = fn


# The exchange between chips has no place here: every cell runs on one card.
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered,
                                   _page_out_altered, _hotness_altered])
def test_faults_under_the_timed_path_fail_the_check(fault):
    res = run(4, fault=fault)
    assert not res.correct, res.gaps
