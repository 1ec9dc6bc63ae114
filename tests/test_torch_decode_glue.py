"""The tiered decode step's once-a-step operands and glue kernels, on the CPU.

``runtime.serve.make_tiered_decode_step`` builds kernel
#1's unified tables for every layer at once, at the top of the step, and
normalises every layer's hotness at once after the last layer. These tests
hold both bit-equal to the per-layer ``ops._unified_operands`` and
``ops.page_hotness`` of the fused path, over several layers, seeds and tier
mixes, and hold ``ops.tiered_decode_attention`` on a layer's slice of the
step's tables, with its raw telemetry, to the same call without them on
both routes. They hold the plain versions of the glue kernels
(``kernels.decode_glue``, which its wrappers run on CPU tensors) bit-equal to
the chain of ops they replace: ``models.attention._project_qkv`` less its
products, with a ``torch.where`` recent-window write. And they count the
launches a capture records: two ``rmsnorm`` a layer and the final one, one
QKV epilogue and one SiLU * up a dense layer, added again by each replay,
M-RoPE's step included. The kernels themselves are held to
these plain versions on the card (``tests/test_torch_cuda.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import TierScapeRunConfig, get_smoke  # noqa: E402
from repro_torch.kernels import build, decode_glue, ops  # noqa: E402
from repro_torch.kernels.paged_attention import NEG_INF, TIER_INVALID  # noqa: E402
from repro_torch.models import Model, attention  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402

L, B, MP, T, KV, HD, H = 5, 3, 12, 8, 2, 16, 4
ROWS = {8: 40, 4: 30}
# (warm bits, cold bits, share of each table's columns in use: warm, cold, host)
MIXES = {
    "mixed": (8, 4, (0.5, 0.5, 0.3)),
    "all_warm": (8, 4, (1.0, 0.0, 0.0)),
    "host_heavy": (8, 4, (0.1, 0.2, 1.0)),
    "same_class": (8, 8, (0.6, 0.6, 0.2)),
}


def _class_buffers(g, bits):
    hdp = HD if bits == 8 else HD // 2
    dt = torch.int8 if bits == 8 else torch.uint8
    pay = torch.randint(0, 100, (ROWS[bits], T, KV, hdp), generator=g).to(dt)
    sc = torch.rand((ROWS[bits], T, KV), generator=g)
    return pay, sc, pay.clone(), sc.clone()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_step_tables_and_hotness_equal_the_per_layer_ones(seed, mix):
    """Every layer's slice of the step-wide unified table equals the table
    ``_unified_operands`` builds for that layer alone (same layout, and a
    contiguous view), and the hotness of all layers at once, sliced by tier,
    equals ``page_hotness`` on each layer's slice of each tier."""
    wb, cb, fill = MIXES[mix]
    g = torch.Generator().manual_seed(seed)

    def table(rows):
        return torch.randint(0, rows, (L, B, MP), generator=g, dtype=torch.int32)

    def counts(share):
        n = torch.rand((L, B), generator=g) * (share * MP + 1)
        return n.to(torch.int32).clamp(max=MP)

    tabs = {"warm": (table(ROWS[wb]), counts(fill[0]), wb),
            "cold": (table(ROWS[cb]), counts(fill[1]), cb)}
    host_table, host_n = table(10), counts(fill[2])
    slot, tier, layout = ops.unified_table(
        {n: {"page_table": t, "n_pages": c, "bits": b} for n, (t, c, b) in tabs.items()},
        {"table": host_table, "n": host_n})
    assert slot.shape == tier.shape == (L, B, 3 * MP)
    ops._check_class_bounds(slot, tier, ROWS[8], ROWS[4])

    bufs = {8: _class_buffers(g, 8), 4: _class_buffers(g, 4)}
    summary = torch.randn((10, KV, HD), generator=g)
    cols = 3 * MP
    stats, per_layer = [], {n: [] for n in layout}
    for li in range(L):
        pools = {n: dict(zip(("k_pages", "k_scales", "v_pages", "v_scales"), bufs[b]),
                         page_table=t[li], n_pages=c[li], bits=b)
                 for n, (t, c, b) in tabs.items()}
        host = {"summary": summary, "table": host_table[li], "n": host_n[li], "page_tokens": T}
        q = torch.randn((B, H, HD), generator=g)
        *_, us, ut, t_, lay = ops._unified_operands(q, pools, torch.zeros((B, 4, KV, HD)), host)
        assert t_ == T and lay == layout
        assert torch.equal(us, slot[li]) and torch.equal(ut, tier[li])
        assert slot[li].is_contiguous() and tier[li].is_contiguous()
        mass = torch.rand((B, cols), generator=g) * (ut != TIER_INVALID)
        base = torch.where(ut != TIER_INVALID, torch.randn((B, cols), generator=g), NEG_INF)
        m = torch.randn((B, H), generator=g)
        lsum = torch.rand((B, H), generator=g) + 0.1
        stats.append((mass, base, m, lsum))
        for n, (lo, hi) in layout.items():  # as ``ops._fused_path`` normalises one layer
            per_layer[n].append(ops.page_hotness(mass[:, lo:hi], base[:, lo:hi], m, lsum))
    whole = ops.page_hotness(*(torch.stack(s) for s in zip(*stats)))
    for n, (lo, hi) in layout.items():
        assert torch.equal(whole[..., lo:hi], torch.stack(per_layer[n])), n


def test_step_table_check_raises_on_a_valid_entry_outside_its_class():
    """The class-bounds check, run once on the step-wide table, raises for
    a valid entry of any layer outside its class buffer; a stale entry past
    its row's count is exempt."""
    table = torch.zeros((L, B, MP), dtype=torch.int32)
    n = torch.full((L, B), 2, dtype=torch.int32)
    pools = {"warm": {"page_table": table, "n_pages": n, "bits": 8}}
    table[3, 1, 5] = ROWS[8]  # past the count: stale
    slot, tier, _ = ops.unified_table(pools, None)
    ops._check_class_bounds(slot, tier, ROWS[8], ROWS[4])
    table[4, 2, 1] = ROWS[8]
    slot, tier, _ = ops.unified_table(pools, None)
    with pytest.raises(IndexError, match="outside the"):
        ops._check_class_bounds(slot, tier, ROWS[8], ROWS[4])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_dispatch_on_the_step_tables_equals_the_per_layer_call(fused, mix):
    """``tiered_decode_attention`` on each layer's slice of ``step_tables``,
    with its raw telemetry normalised once by ``step_hotness``, gives the
    output and hotness of the same call building its own table, bit for
    bit, on the fused route and the per-pool route."""
    wb, cb, fill = MIXES[mix]
    g = torch.Generator().manual_seed(11)
    tabs = {"warm": (torch.randint(0, ROWS[wb], (L, B, MP), generator=g, dtype=torch.int32),
                     (torch.rand((L, B), generator=g) * (fill[0] * MP + 1)).to(torch.int32),
                     wb),
            "cold": (torch.randint(0, ROWS[cb], (L, B, MP), generator=g, dtype=torch.int32),
                     (torch.rand((L, B), generator=g) * (fill[1] * MP + 1)).to(torch.int32),
                     cb)}
    host_table = torch.randint(0, 10, (L, B, MP), generator=g, dtype=torch.int32)
    host_n = (torch.rand((L, B), generator=g) * (fill[2] * MP + 1)).to(torch.int32)
    bufs = {8: _class_buffers(g, 8), 4: _class_buffers(g, 4)}
    summary = torch.randn((10, KV, HD), generator=g)
    rk, rv = (torch.randn((B, 6, KV, HD), generator=g).to(torch.bfloat16) for _ in range(2))
    rlen = torch.tensor([6, 1, 3], dtype=torch.int32)
    ops.use_fused(fused)
    try:
        slot, tier, layout = ops.step_tables(
            {n: {"page_table": t, "n_pages": c, "bits": b} for n, (t, c, b) in tabs.items()},
            {"table": host_table, "n": host_n}, ROWS[8], ROWS[4])
        stats, want = [], []
        for li in range(L):
            pools = {n: dict(zip(("k_pages", "k_scales", "v_pages", "v_scales"), bufs[b]),
                             page_table=t[li], n_pages=c[li], bits=b)
                     for n, (t, c, b) in tabs.items()}
            host = {"summary": summary, "table": host_table[li], "n": host_n[li],
                    "page_tokens": T}
            q = torch.randn((B, H, HD), generator=g).to(torch.bfloat16)
            out, hot = ops.tiered_decode_attention(q, pools, rk, rv, rlen, with_telemetry=True,
                                                   host=host)
            got, raw = ops.tiered_decode_attention(q, pools, rk, rv, rlen, with_telemetry=True,
                                                   host=host, raw=True,
                                                   table=(slot[li], tier[li], layout))
            assert torch.equal(got, out)
            stats.append(raw)
            want.append(hot)
    finally:
        ops.use_fused(True)
    whole = ops.step_hotness(stats, layout)
    assert sorted(whole) == ["cold", "host", "warm"]
    for n in whole:
        assert torch.equal(whole[n], torch.stack([h[n] for h in want])), n


def test_prebuilt_table_refuses_standalone_buffers_of_one_class():
    """A prebuilt table holds class rows with no per-pool offset, so two
    pools of one class on buffers of their own (which the per-layer table
    offsets by the first one's rows) are refused with it, and taken
    without it."""
    g = torch.Generator().manual_seed(5)
    table = torch.zeros((B, MP), dtype=torch.int32)
    n = torch.full((B,), 2, dtype=torch.int32)
    pools = {name: dict(zip(("k_pages", "k_scales", "v_pages", "v_scales"), _class_buffers(g, 8)),
                        page_table=table, n_pages=n, bits=8) for name in ("cold", "warm")}
    q = torch.randn((B, H, HD), generator=g)
    rk = torch.zeros((B, 4, KV, HD), dtype=torch.bfloat16)
    rlen = torch.ones((B,), dtype=torch.int32)
    ops.tiered_decode_attention(q, pools, rk, rk, rlen)
    slot, tier, layout = ops.unified_table(pools, None)
    with pytest.raises(ValueError, match="class-major"):
        ops.tiered_decode_attention(q, pools, rk, rk, rlen, table=(slot, tier, layout))


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "qwen3_32b", "internlm2_20b", "qwen2_vl_72b"])
@pytest.mark.parametrize("rows", [(3, 16), (0, 15)])
def test_qkv_epilogue_plain_is_the_chain_it_replaces(arch, rows):
    """Biases, qk-norm and RoPE (M-RoPE for ``qwen2_vl_72b``) by the step's
    cos and sin (``serve.step_rope``), and the write
    into row ``recent_len[b]`` (nothing at or beyond the window of 16),
    byte-equal to ``_project_qkv`` and a ``torch.where`` row write."""
    cfg = get_smoke(arch)
    params = Model(cfg, device="cpu").init(0)
    g = torch.Generator().manual_seed(7)
    p = dict(layer_params(params["blocks"], 1)["attn"])
    for k in ("bq", "bk", "bv"):
        if k in p:
            p[k] = (0.5 * torch.randn(p[k].shape, generator=g)).to(p[k].dtype)
    for k in ("q_norm", "k_norm"):
        if k in p:
            p[k] = 1 + 0.1 * torch.randn(p[k].shape, generator=g)
    x = torch.randn((2, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    total_len = torch.tensor([37, 90], dtype=torch.int32)
    pos = serve.step_positions(cfg, total_len)
    q0, k0, v0 = attention._project_qkv(p, cfg, x, pos)
    hd, kv, r = cfg.head_dim_(), cfg.n_kv_heads, 16
    window = [torch.randn((2, r, kv, hd), generator=g).to(torch.bfloat16) for _ in range(2)]
    recent_len = torch.tensor(rows, dtype=torch.int32)
    at = (torch.arange(r, dtype=torch.int32)[None, :] == recent_len[:, None])[:, :, None, None]
    want = [torch.where(at, new, w) for new, w in zip((k0, v0), window)]
    got = [w.clone() for w in window]
    cos, sin = serve.step_rope(cfg, total_len, "cpu")
    assert cos.shape == sin.shape == (2, 1, 1, hd // 2)
    q = decode_glue.qkv_epilogue(
        *attention.qkv_products(p, x), cos, sin, *got, recent_len,
        bias=(p["bq"], p["bk"], p["bv"]) if cfg.qkv_bias else None,
        qk_norm=(p["q_norm"], p["k_norm"]) if cfg.qk_norm else None, eps=cfg.norm_eps)
    assert torch.equal(q, q0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if rows[1] >= r:
        assert torch.equal(got[0][1], window[0][1]) and torch.equal(got[1][1], window[1][1])


def _counting(name, fn):
    def run(*args, **kwargs):
        build.count_launch(name)
        return fn(*args, **kwargs)
    return run


# arch -> launches a capture records per attention layer: (rmsnorm, epilogue, SiLU * up)
GLUE_LAUNCHES = {
    "qwen1_5_4b": (2, 1, 1),  # dense SwiGLU, QKV biases
    "qwen3_32b": (2, 1, 1),  # GQA, qk-norm
    "qwen3_moe_235b": (2, 1, 0),  # the experts keep ``layers.swiglu``
    "zamba2_1_2b": (2, 1, 0),  # the shared block's GELU MLP
    "qwen2_vl_72b": (2, 1, 1),  # M-RoPE's cos and sin, made once a step
}


@pytest.mark.parametrize("arch", sorted(GLUE_LAUNCHES))
def test_capture_records_the_glue_launches_once_per_layer(arch, monkeypatch):
    """A capture (``build.recording_launches``; the plain versions stand in
    for the kernels and count a launch each) records two ``rmsnorm`` a layer
    and the final one, one QKV epilogue and one SiLU * up a dense layer, and
    runs none; each replay adds them."""
    for name in ("rmsnorm", "qkv_epilogue", "silu_mul"):
        monkeypatch.setattr(decode_glue, f"{name}_plain",
                            _counting(name, getattr(decode_glue, f"{name}_plain")))
    model = Model(get_smoke(arch), device="cpu")
    params = model.init(0)
    ts = TierScapeRunConfig(enabled=True, async_migration=False, prefetch=False)
    eng = TieredEngine(model, params, ts=ts, device="cpu", batch_slots=2, page_tokens=8,
                       max_seq_len=64, recent_window=16)
    rng = np.random.default_rng(1)
    for n in (20, 13):
        eng.submit(rng.integers(1, model.cfg.vocab_size, n), max_new_tokens=4)
    eng._fill_slots()
    step = serve.make_tiered_decode_step(model, ts, device="cpu")
    tok = torch.ones((2, 1), dtype=torch.int64)
    before = build.launch_counts()
    with build.recording_launches() as held:
        step(params, tok, eng.cache.state, eng.ssm_state)
    assert build.launch_counts() == before  # a capture runs nothing
    norms, epi, silu = GLUE_LAUNCHES[arch]
    expect = {"rmsnorm": norms * eng.la + (1 if norms else 0), "qkv_epilogue": epi * eng.la,
              "silu_mul": silu * eng.la}
    assert {k: held[k] for k in expect} == expect
    graph = {k: n for k, n in held.items() if n}
    build.count_replay(graph)
    build.count_replay(graph)
    after = build.launch_counts()
    assert {k: after[k] - before[k] for k in expect} == {k: 2 * n for k, n in expect.items()}
