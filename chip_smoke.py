"""GPU smoke of the PyTorch/CUDA port: builds the kernels, holds each against
its plain version, and drives the tiered serving loop at the full width of
``qwen1_5_4b`` on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA GPU

Phases (any failure exits non-zero before the result line):
  1. print the card's name and power limit, build the three CUDA kernels;
  2. each kernel vs its plain version on the card at the serving path's
     full-width shapes (T=16, KV=20, hd=128; quant/transcode byte-equal,
     fused attention within 2e-4);
  3. the full-width engine (40 layers, random bf16 weights from a seed)
     serves 3 requests through ``TieredEngine.submit``/``run`` with serial
     migration; the launch counts prove every decode layer ran the fused
     kernel and that page-out and migration ran the quant and transcode
     kernels;
  4. mid-run, one tiered decode step twice on the same state: kernel vs
     plain branch (logits and per-page hotness);
  5. each kernel held to its plain version again and timed at the shapes
     the run gave it (attention: the live mid-run state), their bounds, the
     engine's decode/prefill/window times, tokens/s and peak memory, and a
     profile of one decode step (device time by kernel, busy share).
The last line is the JSON result ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import TierScapeRunConfig, get  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quant_page, transcode_page  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ATTN_TOL = 2e-4
SEED = 0
DEV = "cuda"
T, R, PAGE_LAYERS = 16, 32, 40
REPLACES = {
    "fused_tiered_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:399"),
    "quant_pages": ("src/repro_torch/csrc/quant_page.cu", "src/repro/kernels/quant_page.py:39"),
    "transcode_pages": ("src/repro_torch/csrc/transcode_page.cu",
                        "src/repro/kernels/transcode_page.py:62"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, iters: int = 20, flush_bytes: int = 128 << 20) -> float:
    """Median device time of ``fn`` (CUDA events around each call, the L2
    flushed by a 128 MB write between calls, after 3 warm-up calls)."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        scratch.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def phase_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{name}] {line.strip()}")
    return smi


# ---------------------------------------------------------------- phase 2
def _dequant_err(pk, sk, pp, sp, bits) -> float:
    return float((ref.dequant_kv_page(pk, sk, bits) - ref.dequant_kv_page(pp, sp, bits))
                 .abs().max())


def check_quant(pages: torch.Tensor, bits: int) -> float:
    pk, sk = quant_page.quant_pages(pages, bits)
    pp, sp = ref.quant_kv_page(pages, bits)
    torch.cuda.synchronize()
    if not torch.equal(pk, pp):
        fail(f"quant_pages int{bits}: payload differs from the plain version in "
             f"{int((pk != pp).sum())} bytes")
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0)
    return _dequant_err(pk, sk, pp, sp, bits)


def check_transcode(pay, sc, src, dst) -> float:
    pk, sk = transcode_page.transcode_pages(pay, sc, src, dst)
    pp, sp = ref.transcode_kv_page(pay, sc, src, dst)
    torch.cuda.synchronize()
    if not torch.equal(pk, pp):
        fail(f"transcode_pages {src}->{dst}: payload differs in {int((pk != pp).sum())} bytes")
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0)
    return _dequant_err(pk, sk, pp, sp, dst)


def attention_operands(g: torch.Generator, b: int, h: int, kv: int, hd: int, mp: int):
    """A mixed unified table at the engine's shapes: per sequence, warm
    (int8), cold (int4) and host columns of ``mp`` rows each, with valid
    prefixes of different lengths, invalid tails, and one sequence whose
    recent window is empty."""
    dev = DEV
    p8, p4, hs = 4 * mp, 4 * mp, 2 * mp

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    k8, s8k = ref.quant_kv_page(rn(p8, T, kv, hd), 8)
    v8, s8v = ref.quant_kv_page(rn(p8, T, kv, hd) * 0.5, 8)
    k4, s4k = ref.quant_kv_page(rn(p4, T, kv, hd), 4)
    v4, s4v = ref.quant_kv_page(rn(p4, T, kv, hd) * 0.5, 4)
    summary = rn(hs, kv, hd)
    q = rn(b, h, hd).to(torch.bfloat16)
    rk = rn(b, R, kv, hd).to(torch.bfloat16)
    rv = rn(b, R, kv, hd).to(torch.bfloat16)
    n_valid = [(40, 25, 12), (7, 60, 30)][:b]
    slots, tiers = [], []
    for nw, nc, nh in n_valid:
        row_s, row_t = [], []
        cols = ((nw, pa.TIER_INT8, p8), (nc, pa.TIER_INT4, p4), (nh, pa.TIER_HOST, hs))
        for n, code, rows in cols:
            s = torch.randint(0, rows, (mp,), generator=g, device=dev, dtype=torch.int32)
            t = torch.full((mp,), pa.TIER_INVALID, dtype=torch.int32, device=dev)
            t[:n] = code
            row_s.append(s)
            row_t.append(t)
        slots.append(torch.cat(row_s))
        tiers.append(torch.cat(row_t))
    rlen = torch.tensor([R, 0][:b], dtype=torch.int32, device=dev)
    return (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv,
            torch.stack(slots).contiguous(), torch.stack(tiers).contiguous(), rlen, T)


def check_attention(operands) -> float:
    got = pa.fused_tiered_attention(*operands)
    want = pa.fused_tiered_attention_plain(*operands)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, w in zip(("out", "m", "l", "mass", "base"), got, want):
        if not torch.isfinite(a).all():
            fail(f"fused_tiered_attention: non-finite {name}")
        torch.testing.assert_close(a, w, rtol=ATTN_TOL, atol=ATTN_TOL, msg=lambda m: f"{name}: {m}")
        err = max(err, float((a - w).abs().max()))
    return err


def phase_compare(cfg) -> dict:
    g = torch.Generator(device=DEV).manual_seed(SEED)
    kv, hd, h = cfg.n_kv_heads, cfg.head_dim_(), cfg.n_heads
    errs = {}
    # Page-out of a 512-token prompt: K and V of 40 layers x 31 pages.
    pages = torch.randn((2 * PAGE_LAYERS * 31, T, kv, hd), generator=g, device=DEV)
    errs["quant_pages"] = max(check_quant(pages, 8), check_quant(pages, 4))
    # A migration cohort: K and V of 40 layers x 8 pages, both directions.
    e = 0.0
    for src, dst in ((8, 4), (4, 8)):
        pay, sc = ref.quant_kv_page(pages[: 2 * PAGE_LAYERS * 8], src)
        e = max(e, check_transcode(pay, sc, src, dst))
    errs["transcode_pages"] = e
    del pages
    mp = 1024 // T  # the engine's max pages per sequence
    errs["fused_tiered_attention"] = check_attention(attention_operands(g, 2, h, kv, hd, mp))
    log(f"phase 2 ok: kernels match their plain versions, max abs err {errs}")
    return errs


# ---------------------------------------------------------------- phase 3-4
class ShapeSpy:
    """Records the largest operand shape the engine hands a dispatch
    function (so phase 5 times each kernel at the serving path's own
    shapes); it keeps no tensor alive."""

    def __init__(self, fn):
        self.fn = fn
        self.largest = None  # (numel, shape, dtype, other args)

    def __call__(self, x, *args):
        if self.largest is None or x.numel() > self.largest[0]:
            self.largest = (x.numel(), tuple(x.shape), x.dtype, args)
        return self.fn(x, *args)


def step_compare(eng: TieredEngine) -> dict:
    """One decode step on the engine's live state, kernel branch vs plain
    branch. Logits: the bf16 activations round the attention output, so one
    f32-ulp difference in a kernel output can flip a bf16 rounding and
    compound over 40 layers; the bar is 2% of the logits' largest magnitude.
    Hotness (normalized per-page mass) is held to 2e-4."""
    tokens = torch.zeros((eng.bs, 1), dtype=torch.int64, device=DEV)
    for i, req in enumerate(eng.slots):
        if req is not None and req.out_tokens:
            tokens[i, 0] = req.out_tokens[-1]
    st = eng.cache.state
    k_step = serve.make_tiered_decode_step(eng.model, eng.ts, use_kernels=True, device=DEV)
    p_step = serve.make_tiered_decode_step(eng.model, eng.ts, use_kernels=False, device=DEV)
    lk, _, _, hk = k_step(eng.params, tokens, st, None)
    lp, _, _, hp = p_step(eng.params, tokens, st, None)
    torch.cuda.synchronize()
    lk, lp = lk.float(), lp.float()
    if not torch.isfinite(lk).all():
        fail("kernel-branch logits are not finite")
    scale = float(lp.abs().max())
    dl = float((lk - lp).abs().max())
    if dl > 0.02 * scale:
        fail(f"decode-step logits: kernel vs plain differ by {dl} (> 2% of {scale})")
    dh = {}
    for name in ("warm", "cold", "host"):
        torch.testing.assert_close(hk[name], hp[name], rtol=ATTN_TOL, atol=ATTN_TOL,
                                   msg=lambda m: f"hotness[{name}]: {m}")
        dh[name] = float((hk[name] - hp[name]).abs().max())
    same = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    log(f"phase 4 ok: step kernel vs plain: logits max diff {dl:.4g} (max |logit| "
        f"{scale:.4g}), greedy tokens equal {same}, hotness max diff {dh}")
    return {"logits_max_diff": dl, "hotness_max_diff": dh}


def phase_engine(cfg):
    model = Model(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    log(f"init {cfg.name}: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params, "
        f"{time.perf_counter() - t0:.1f} s")
    ts = TierScapeRunConfig(enabled=True, window_steps=16, async_migration=False,
                            prefetch=False, faults=False)
    torch.cuda.reset_peak_memory_stats()
    eng = TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                       recent_window=R, ts=ts, device=DEV)
    rng = np.random.default_rng(SEED)
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, int(n)), max_new_tokens=48)
            for n in rng.integers(400, 601, 3)]
    spies = {"quant_pages": ShapeSpy(ops.quant_pages),
             "transcode_pages": ShapeSpy(ops.transcode_pages)}
    ops.quant_pages, ops.transcode_pages = spies["quant_pages"], spies["transcode_pages"]

    build.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(max_steps=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    before = build.launch_counts()
    step = step_compare(eng)
    # Phase 5 times the attention kernel on this mid-run state: keep its
    # tables and recent window (the class buffers are shared and stay valid).
    st = eng.cache.state
    state_for_timing = dataclasses.replace(st, **{
        f: getattr(st, f).clone() for f in (
            "warm_table", "warm_n", "cold_table", "cold_n", "host_table", "host_n",
            "recent_k", "recent_v", "recent_len")})
    compare_launches = {k: v - before[k] for k, v in build.launch_counts().items()}
    t0 = time.perf_counter()
    stats = eng.run()
    forced = False
    if build.launch_counts()["transcode_pages"] - compare_launches["transcode_pages"] == 0:
        forced = force_migration(eng)
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    counts = {k: v - compare_launches[k] for k, v in build.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    ops.quant_pages, ops.transcode_pages = spies["quant_pages"].fn, spies["transcode_pages"].fn

    if stats.completed != 3 or not all(r.done and len(r.out_tokens) == 48 for r in reqs):
        fail(f"not every request completed: {stats.completed}/3")
    if counts["fused_tiered_attention"] != cfg.n_layers * stats.steps:
        fail(f"fused_tiered_attention launched {counts['fused_tiered_attention']} times, "
             f"expected {cfg.n_layers} x {stats.steps} decode steps")
    if counts["quant_pages"] < 1 or counts["transcode_pages"] < 1:
        fail(f"page-out/migration kernels not on the path: {counts}")
    if stats.attn_launches != counts["fused_tiered_attention"]:
        fail(f"billed attention launches {stats.attn_launches} != counted {counts}")
    gen = sum(len(r.out_tokens) for r in reqs)
    eng_metrics = {
        "decode_steps": stats.steps,
        "windows": stats.windows,
        "migrations": stats.migrations,
        "forced_migration": forced,
        "decode_ms_per_step": stats.decode_s / stats.steps * 1e3,
        "prefill_ms_per_request": stats.prefill_s / len(reqs) * 1e3,
        "window_ms_per_boundary": stats.window_s / max(stats.windows, 1) * 1e3,
        "tokens_per_s": gen / wall,
        "wall_s": wall,
        "generated_tokens": gen,
        "peak_memory_bytes": peak,
        "tco_savings_pct": stats.tco_savings_pct,
        "prompt_lens": [len(r.prompt) for r in reqs],
    }
    log(f"phase 3 ok: {json.dumps(eng_metrics)}; launches {counts}")
    return eng, counts, eng_metrics, spies, state_for_timing, step


def force_migration(eng: TieredEngine) -> bool:
    """The policy moved no page between codecs in this run: drive the
    cohort executor by hand, warm pages to the cold tier and back."""
    cache = eng.cache
    from repro_torch.serving import kv_cache as kvc

    warm = np.where((cache.physical == kvc.WARM) & cache._page_exists)[0][:64]
    if warm.size == 0:
        for i in range(eng.bs):  # everything finished: serve one more request
            if eng.slots[i] is None:
                eng.submit(np.arange(1, 600) % eng.cfg.vocab_size, max_new_tokens=2)
        eng._fill_slots()
        warm = np.where((cache.physical == kvc.WARM) & cache._page_exists)[0][:64]
    moved = cache.migrate_batch(warm, np.full(warm.size, kvc.COLD, np.int64))
    moved += cache.migrate_batch(warm, np.full(warm.size, kvc.WARM, np.int64))
    log(f"policy planned no codec change: drove migrate_batch on {warm.size} warm pages "
        f"to the cold tier and back ({moved} page moves)")
    return True


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- phase 5
def attention_work(operands) -> tuple:
    """Bytes and f32 operations the fused kernel needs for these inputs:
    valid pool pages' K/V payload + scales, host centroids, the filled part
    of the recent window, q, the tables and the outputs."""
    (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv,
     slot, tier, rlen, t) = operands
    b, h, hd = q.shape
    kv = k8.shape[2]
    n8 = int((tier == pa.TIER_INT8).sum())
    n4 = int((tier == pa.TIER_INT4).sum())
    nh = int((tier == pa.TIER_HOST).sum())
    nr = int(rlen.sum())
    ms = slot.shape[1]
    page8 = 2 * (t * kv * hd + t * kv * 4)
    page4 = 2 * (t * kv * hd // 2 + t * kv * 4)
    n_bytes = (n8 * page8 + n4 * page4 + nh * kv * hd * 4 + nr * 2 * kv * hd * 2
               + q.numel() * q.element_size() + 2 * b * ms * 4 + b * 4
               + b * h * hd * 4 + 2 * b * h * 4 + 2 * b * ms * 4)
    n_ops = (n8 + n4) * (4 * h * t * hd + 2 * t * kv * hd) + nh * 2 * h * hd + nr * 4 * h * hd
    return n_bytes, n_ops


def phase_times(eng, counts, spies, state, errs) -> list:
    rows = []
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    # quant_pages at the largest page-out batch of the run.
    _, shape, dtype, (bits,) = spies["quant_pages"].largest
    pages = torch.randn(shape, generator=g, device=DEV).to(dtype)
    errs["quant_pages"] = max(errs["quant_pages"], check_quant(pages, bits))
    n = pages.numel()
    out_b = n if bits == 8 else n // 2
    qb = bound_ms(n * pages.element_size() + out_b + n // pages.shape[-1] * 4, 6 * n)
    rows.append(("quant_pages", time_ms(lambda: quant_page.quant_pages(pages, bits)),
                 time_ms(lambda: ref.quant_kv_page(pages, bits)), qb,
                 f"{tuple(pages.shape)} {pages.dtype} -> int{bits}"))
    # transcode_pages at the largest migration cohort of the run.
    _, shape, _, (_, src, dst) = spies["transcode_pages"].largest
    hd_src = shape[-1] * (1 if src == 8 else 2)
    pay, sc = ref.quant_kv_page(
        torch.randn(shape[:-1] + (hd_src,), generator=g, device=DEV), src)
    errs["transcode_pages"] = max(errs["transcode_pages"], check_transcode(pay, sc, src, dst))
    in_b = pay.numel() + sc.numel() * 4
    hd = pay.shape[-1] * (1 if src == 8 else 2)
    elems = sc.numel() * hd
    out_b = (elems if dst == 8 else elems // 2) + sc.numel() * 4
    tb = bound_ms(in_b + out_b, 8 * elems)
    rows.append(("transcode_pages",
                 time_ms(lambda: transcode_page.transcode_pages(pay, sc, src, dst)),
                 time_ms(lambda: ref.transcode_kv_page(pay, sc, src, dst)), tb,
                 f"{tuple(pay.shape)} int{src} -> int{dst}"))
    # fused_tiered_attention on layer 0 of the live mid-run state.
    layer = {f: getattr(state, f)[0] for f in serve.LAYER_FIELDS}
    pools = {
        "warm": {"k_pages": layer["c8_k"], "k_scales": layer["c8_k_scales"],
                 "v_pages": layer["c8_v"], "v_scales": layer["c8_v_scales"],
                 "page_table": layer["warm_table"], "n_pages": layer["warm_n"], "bits": 8},
        "cold": {"k_pages": layer["c4_k"], "k_scales": layer["c4_k_scales"],
                 "v_pages": layer["c4_v"], "v_scales": layer["c4_v_scales"],
                 "page_table": layer["cold_table"], "n_pages": layer["cold_n"], "bits": 4},
    }
    host = {"summary": layer["host_summary"], "table": layer["host_table"],
            "n": layer["host_n"], "page_tokens": T}
    cfg = eng.cfg
    q = torch.randn((eng.bs, cfg.n_heads, cfg.head_dim_()), device=DEV).to(torch.bfloat16)
    (k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, slot, tier, t, _) = ops._unified_operands(
        q, pools, layer["recent_k"], host)
    rlen = (state.recent_len + 1).to(torch.int32).contiguous()
    operands = (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, layer["recent_k"],
                layer["recent_v"], slot, tier, rlen, t)
    errs["fused_tiered_attention"] = max(errs["fused_tiered_attention"],
                                         check_attention(operands))
    ab = bound_ms(*attention_work(operands))
    rows.append(("fused_tiered_attention",
                 time_ms(lambda: pa.fused_tiered_attention(*operands)),
                 time_ms(lambda: pa.fused_tiered_attention_plain(*operands)), ab,
                 f"B={eng.bs} MS={slot.shape[1]} valid rows int8/int4/host="
                 f"{int((tier == 0).sum())}/{int((tier == 1).sum())}/{int((tier == 2).sum())}"))
    out = []
    for name, ms, plain_ms, (b_ms, b_by), shape in rows:
        src_path, replaces = REPLACES[name]
        out.append({
            "name": name, "route": "cuda", "source": src_path, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": shape,
        })
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}) "
            f"at {shape}")
    return out


def phase_profile(eng, state) -> dict:
    """Where one decode step's time goes: 3 kernel-branch steps on the
    mid-run state under ``torch.profiler``; device time by kernel and the
    device's busy share of the host wall time."""
    from torch.profiler import ProfilerActivity, profile

    step = serve.make_tiered_decode_step(eng.model, eng.ts, use_kernels=True, device=DEV)
    tokens = torch.ones((eng.bs, 1), dtype=torch.int64, device=DEV)
    step(eng.params, tokens, state, None)
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(eng.params, tokens, state, None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    if device_ms <= 0:
        fail("the profiler recorded no device time")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    out = {
        "step_wall_ms": wall_ms,
        "step_device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "top_device_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / n for e in top},
    }
    log(f"phase 5 profile: {json.dumps(out)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get("qwen1_5_4b")
    smi = phase_build()
    errs = phase_compare(cfg)
    eng, counts, eng_metrics, spies, state, step = phase_engine(cfg)
    kernels = phase_times(eng, counts, spies, state, errs)
    prof = phase_profile(eng, state)
    log(json.dumps({"card": smi, "engine": eng_metrics, "step_compare": step,
                    "decode_step_profile": prof}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
