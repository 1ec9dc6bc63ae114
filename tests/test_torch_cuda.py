"""The CUDA kernels against their plain versions, on a GPU.

Torch-only (the GPU host has no JAX): quant, transcode, dequant (f32 and
bf16 out) and the cxl_hw page codec (encode: payload, scales and line widths;
decode) byte-equal (quant and transcode also at hd 16-256, ragged row counts,
all-zero rows and exact ties; dequant at every even hd 2-256; the cxl encode
at hd 64-256 with lines at exactly 7 and 8 and ties; each row-group kernel
refusing a view off its 16-byte vectors), fused and per-pool attention
within rtol = atol = 2e-4,
across the reference sweep of page shapes and head groupings (GQA included),
mixed int8/int4/host/invalid table rows, empty pools and recent windows, and
every kernel at the zamba2 page shape (T=16, KV=H=32, hd=64); the cache's
executors (serial, per-page, and the async pipeline through the pinned ring)
on the GPU against the CPU; and, at the SMOKE size, a preempted request
resumed into another slot with the uninterrupted run's tokens and table
order, park/restore table invariants, the frontend scheduler over two
replicas through a replica failure (every request done, zero re-prefill,
attention launches equal to the billed ones), and the mamba2 SMOKE's decode
against its forward; a full-width MoE layer twice on the same inputs
byte-equal; and the training path: SMOKE train steps that descend (AdamW
and tiered Adam), the int8 MoE wire's backward equal to the CPU's, and a
checkpoint of the card's tensors restored bit for bit; the serving example's
8-token pages and 16-token recent window (fused attention, quant, transcode
and dequant against their plain versions), the sequence-parallel pool
attention on a one-device mesh (byte-equal to the per-pool kernel) and split
over two shards in turn (against the plain version with global slot
positions), and the dense decode step on the card against the CPU at the
SMOKE size; and the engine's captured decode step (one CUDA graph replayed
per token) byte-equal to the eager kernel step at every step of the dense,
GQA, MoE, VLM and hybrid SMOKE engines, captured again on a route change
and on a moved class buffer, and its launches counted per replay with no
class-bounds check inside a replay. Every test skips where
``torch.cuda.is_available()`` is False; on the GPU host run

    python -m pytest -q tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, cxl_line, ops, ref  # noqa: E402
from repro_torch.kernels import dequant_page, quant_page, transcode_page  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

SWEEP = [(4, 8, 1, 32), (4, 16, 4, 64), (8, 32, 2, 128), (2, 64, 8, 128)]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_and_transcode_byte_equal(gen, shape, dtype):
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = build.launch_counts()
    for bits in (8, 4):
        kp, ks = quant_page.quant_pages(x, bits)
        rp, rs = ref.quant_kv_page(x, bits)
        assert torch.equal(kp, rp) and torch.equal(ks, rs)
        tp, ts = transcode_page.transcode_pages(kp, ks, bits, 12 - bits)
        up, us = ref.transcode_kv_page(kp, ks, bits, 12 - bits)
        assert torch.equal(tp, up) and torch.equal(ts, us)
    after = build.launch_counts()
    assert after["quant_pages"] - before["quant_pages"] == 2
    assert after["transcode_pages"] - before["transcode_pages"] == 2


def _tie_pages(rows: int, hd: int, dtype) -> torch.Tensor:
    """Rows whose codes are exact round-half-even ties: amax = 127 * 2^e sets
    scale = 2^e and the other values are (k + 0.5) * 2^e (exact in bf16 as in
    f32); every third row is all zero (scale 1)."""
    k = torch.arange(hd, device="cuda", dtype=torch.float32) % 254 - 127
    e = torch.arange(rows, device="cuda", dtype=torch.float32) % 9 - 4
    x = (k + 0.5)[None, :].clamp(-126.5, 126.5) * torch.exp2(e)[:, None]
    x[:, 0] = 127 * torch.exp2(e)
    x[::3] = 0
    return x.to(dtype).reshape(rows, 1, 1, hd)


def _transcode_tie_payload(rows: int, hd: int, bits: int) -> tuple:
    """Payloads whose requantization meets exact ties: int8 rows with amax
    code 126 hold 9 (q = 9 * 7 / 126 = 0.5), int4 rows with amax code -8 hold
    4 (q = 4 * 127 / 8 = 63.5); old scales of 1, 2^-3 and 0.37. Every fifth
    int8 row holds -128, the code without a positive twin."""
    if bits == 8:
        codes = torch.tensor([126, 9, -9, 27, -45, 0, 1, -126], device="cuda", dtype=torch.int8)
        pay = codes.repeat(rows, (hd + 7) // 8)[:, :hd].clone()
        pay[::5, 1] = -128
    else:
        nib = torch.tensor([-8, 4, -4, 3, 0, 7, -1, 2], device="cuda", dtype=torch.int32)
        q = nib.repeat(rows, (hd + 7) // 8)[:, :hd]
        pay = ((q[:, 0::2] & 0xF) | ((q[:, 1::2] & 0xF) << 4)).to(torch.uint8)
    sc = torch.tensor([1.0, 0.125, 0.37], device="cuda").repeat(rows)[:rows]
    return pay.reshape(rows, 1, 1, -1).contiguous(), sc.reshape(rows, 1, 1).contiguous()


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_group_kernels_byte_equal(gen, hd, dtype):
    """quant_pages (f32 and bf16 in) and transcode_pages (both directions)
    byte-equal to their plain versions at ragged row counts, on random rows
    (some all zero) and on exact ties; one launch per call."""
    for rows in (1, 7, 33, 320, 4097):
        x = torch.randn((rows, 1, 1, hd), generator=gen, device="cuda")
        x *= torch.exp2(torch.randint(-8, 8, (rows, 1, 1, 1), generator=gen, device="cuda"))
        x[::5] = 0
        for pages in (x.to(dtype), _tie_pages(rows, hd, dtype)):
            for bits in (8, 4):
                before = build.launch_counts()
                kp, ks = quant_page.quant_pages(pages, bits)
                rp, rs = ref.quant_kv_page(pages, bits)
                assert torch.equal(kp, rp) and torch.equal(ks, rs), (rows, bits)
                tp, ts = transcode_page.transcode_pages(kp, ks, bits, 12 - bits)
                up, us = ref.transcode_kv_page(kp, ks, bits, 12 - bits)
                assert torch.equal(tp, up) and torch.equal(ts, us), (rows, bits)
                after = build.launch_counts()
                assert after["quant_pages"] - before["quant_pages"] == 1
                assert after["transcode_pages"] - before["transcode_pages"] == 1
        for bits in (8, 4):
            pay, sc = _transcode_tie_payload(rows, hd, bits)
            tp, ts = transcode_page.transcode_pages(pay, sc, bits, 12 - bits)
            up, us = ref.transcode_kv_page(pay, sc, bits, 12 - bits)
            assert torch.equal(tp, up) and torch.equal(ts, us), (rows, bits, "ties")


def test_row_group_wrappers_reject_misaligned_views(gen):
    """A contiguous view 8 bytes off the 16-byte vectors the geometry loads
    raises (pair-aligned, which the other kernels take): no narrower path."""
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.randn(2 * 16 * 2 * 64 + 16, generator=gen, device="cuda").to(dtype)
        off = 8 // flat.element_size()
        x = flat[off:off + 2 * 16 * 2 * 64].view(2, 16, 2, 64)
        assert x.is_contiguous() and x.data_ptr() % 16 == 8
        with pytest.raises(ValueError, match="aligned"):
            quant_page.quant_pages(x, 8)
    pay, sc = quant_page.quant_pages(torch.randn((3, 16, 2, 64), generator=gen,
                                                 device="cuda"), 8)
    flat = torch.zeros(pay.numel() + 8, dtype=torch.int8, device="cuda")
    view = flat[8:].view(pay.shape)
    view.copy_(pay)
    with pytest.raises(ValueError, match="aligned"):
        transcode_page.transcode_pages(view, sc, 8, 4)


@pytest.mark.parametrize("t, kv, hd", [(8, 1, 32), (16, 4, 64), (16, 2, 128), (64, 8, 128)])
@pytest.mark.parametrize("group", [1, 4])
def test_fused_attention_matches_plain(gen, t, kv, hd, group):
    b, r, mp, h = 3, 6, 5, kv * group
    dev = "cuda"

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    k8, s8k = ref.quant_kv_page(rn(7, t, kv, hd), 8)
    v8, s8v = ref.quant_kv_page(rn(7, t, kv, hd), 8)
    k4, s4k = ref.quant_kv_page(rn(6, t, kv, hd), 4)
    v4, s4v = ref.quant_kv_page(rn(6, t, kv, hd), 4)
    summary = rn(4, kv, hd)
    q = rn(b, h, hd).to(torch.bfloat16)
    rk, rv = rn(b, r, kv, hd).to(torch.bfloat16), rn(b, r, kv, hd).to(torch.bfloat16)
    codes = torch.tensor([pa.TIER_INT8, pa.TIER_INT4, pa.TIER_HOST, pa.TIER_INVALID], device=dev)
    tier = codes[torch.randint(0, 4, (b, 3 * mp), generator=gen, device=dev)].to(torch.int32)
    tier[1] = pa.TIER_HOST  # one sequence sees host sentinels only
    rows = torch.where(tier == pa.TIER_INT8, 7, torch.where(tier == pa.TIER_INT4, 6, 4))
    slot = (torch.rand((b, 3 * mp), generator=gen, device=dev) * rows).to(torch.int32)
    rlen = torch.tensor([r, 0, 2], dtype=torch.int32, device=dev)
    args = (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv, slot, tier, rlen, t)
    got = pa.fused_tiered_attention(*args)
    want = pa.fused_tiered_attention_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_dequant_pages_bit_equal(gen, shape, out_dtype):
    x = torch.randn(shape, generator=gen, device="cuda")
    before = build.launch_counts()["dequant_pages"]
    for bits in (8, 4):
        pay, sc = ref.quant_kv_page(x, bits)
        got = dequant_page.dequant_pages(pay, sc, bits, out_dtype)
        want = dequant_page.dequant_pages_plain(pay, sc, bits, out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, want)
    assert build.launch_counts()["dequant_pages"] - before == 2


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_dequant_pages_every_head_dim(gen, bits, out_dtype):
    """Every even head_dim 2-256 (every vector width and lane count of the
    dequant geometry) at row counts that leave a partial last batch, codes
    over the whole range (int8 -128 included) and scales over 2^-20 to 2^20
    with zero rows: bit-equal to the plain version, one launch a call."""
    for hd in range(2, 257, 2):
        for rows in (1, 37, 1031):
            q = torch.randint(-128 if bits == 8 else -8, 128 if bits == 8 else 8, (rows, hd),
                              generator=gen, device="cuda", dtype=torch.int32)
            pay = (q.to(torch.int8) if bits == 8 else
                   ((q[:, 0::2] & 0xF) | ((q[:, 1::2] & 0xF) << 4)).to(torch.uint8))
            sc = torch.exp2(torch.randint(-20, 20, (rows,), generator=gen, device="cuda")
                            .float()) * torch.rand(rows, generator=gen, device="cuda")
            sc[::4] = 0
            pay, sc = pay.reshape(rows, 1, 1, -1), sc.reshape(rows, 1, 1)
            before = build.launch_counts()["dequant_pages"]
            got = dequant_page.dequant_pages(pay, sc, bits, out_dtype)
            assert build.launch_counts()["dequant_pages"] - before == 1
            want = dequant_page.dequant_pages_plain(pay, sc, bits, out_dtype)
            assert got.dtype == out_dtype and torch.equal(got, want), (hd, rows)


def test_dequant_pages_rejects_misaligned_views(gen):
    """A contiguous, pair-aligned payload view off the vectors the geometry
    loads (the codes of 16 output bytes: 4 B of int8 for f32, 8 B for bf16)
    raises ValueError (no narrower path, no plain fallback)."""
    pay, sc = quant_page.quant_pages(torch.randn((3, 16, 2, 64), generator=gen,
                                                 device="cuda"), 8)
    flat = torch.zeros(pay.numel() + 2, dtype=torch.int8, device="cuda")
    view = flat[2:].view(pay.shape)
    view.copy_(pay)
    assert view.is_contiguous() and view.data_ptr() % 4 == 2
    for out_dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="aligned"):
            dequant_page.dequant_pages(view, sc, 8, out_dtype)


def _line_pages(rows: int, hd: int) -> torch.Tensor:
    """Rows whose scale is 2^e (element 0 is 127 * 2^e) and whose later
    64-code lines hold, by (row + line) % 4: integers up to exactly 7 (width
    4), integers reaching -8 (width 8), ties (k + 0.5) 2^e up to 6.5 (rounded
    to even: max |code| 6, width 4, through exact_codes), ties up to 7.5
    (code 8, width 8). Every third row is all zero (scale 1, width 4)."""
    r = torch.arange(rows, device="cuda")
    e = (r % 9 - 4).float()
    d = torch.arange(hd, device="cuda") % 64
    line = torch.arange(hd, device="cuda") // 64
    kind = (r[:, None] + line[None, :]) % 4
    ints7 = (d % 15 - 7).float()  # -7..7
    ints8 = -((d % 9).float())  # 0..-8
    ties6 = (d % 14 - 7).float().clamp(-7, 6) + 0.5  # -6.5..6.5
    ties7 = (d % 16 - 8).float() + 0.5  # -7.5..7.5
    vals = torch.stack([ints7, ints8, ties6, ties7])[kind, d[None, :].expand(rows, -1)]
    x = vals * torch.exp2(e)[:, None]
    x[:, 0] = 127 * torch.exp2(e)
    x[::3] = 0
    return x.reshape(rows, 1, 1, hd)


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cxl_encode_pages_line_layout(gen, hd, dtype):
    """Payload, scales and line widths equal the plain version's and payload
    and scales quant_pages(., 8)'s, at row counts that are not a multiple of
    the row groups a block holds, on random rows (some zero) and on rows
    whose lines reach exactly 7, exactly 8 and rounding ties."""
    for rows in (1, 7, 33, 1000, 4097):
        x = torch.randn((rows, 1, 1, hd), generator=gen, device="cuda")
        x *= torch.exp2(torch.randint(-8, 8, (rows, 1, 1, 1), generator=gen, device="cuda"))
        x[:, ..., 64:] *= 0.02
        x[::5] = 0
        for pages in (x.to(dtype), _line_pages(rows, hd).to(dtype)):
            before = build.launch_counts()["cxl_encode_pages"]
            got = cxl_line.cxl_encode_pages(pages)
            assert build.launch_counts()["cxl_encode_pages"] - before == 1
            want = ref.cxl_encode_kv_page(pages)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (rows, hd)
            qp, qs = quant_page.quant_pages(pages, 8)
            assert torch.equal(got[0], qp) and torch.equal(got[1], qs), (rows, hd)
        bits = got[2].reshape(rows, -1)
        assert bool((bits[::3] == 4).all())  # zero rows
        if hd > 64 and rows > 3:
            assert bool((bits[1::3, 1:] == 4).any()) and bool((bits[1::3, 1:] == 8).any())


@pytest.mark.parametrize("t, kv, hd", [(8, 1, 32), (16, 4, 64), (16, 2, 128), (16, 20, 128)])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("bits", [8, 4])
def test_paged_quant_attention_matches_plain(gen, t, kv, hd, group, bits):
    """One pool: a long, a one-page and an empty sequence (m = l = 0), and
    table tails past n_pages; a valid entry outside the pool raises."""
    b, mp, p, h = 3, 9, 7, kv * group
    pay, sc = ref.quant_kv_page(torch.randn((p, t, kv, hd), generator=gen, device="cuda"), bits)
    vpay, vsc = ref.quant_kv_page(torch.randn((p, t, kv, hd), generator=gen, device="cuda"), bits)
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
    table = torch.randint(0, p, (b, mp), generator=gen, device="cuda", dtype=torch.int32)
    n = torch.tensor([mp, 1, 0], dtype=torch.int32, device="cuda")
    args = (q, pay, sc, vpay, vsc, table, n, bits)
    before = build.launch_counts()["paged_quant_attention"]
    got = pa.paged_quant_attention(*args)
    want = ref.paged_quant_attention(*args)
    assert build.launch_counts()["paged_quant_attention"] - before == 1
    for name, g, w in zip(("out", "m", "l", "mass", "base"), got, want):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"{name}: {m}")
    assert float(got[1][2].abs().max()) == 0.0 and float(got[2][2].abs().max()) == 0.0
    bad = table.clone()
    bad[0, 3] = p
    with pytest.raises(IndexError):
        pa.paged_quant_attention(q, pay, sc, vpay, vsc, bad, n, bits)


def test_per_pool_path_matches_fused(gen):
    """``use_fused(False)``: one per-pool launch per pool, outputs and
    hotness equal to the fused launch within 2e-4."""
    t, kv, hd, b, h, r, mp = 16, 2, 64, 2, 8, 6, 5

    def pool(bits, n_valid):
        pay, sc = ref.quant_kv_page(torch.randn((6, t, kv, hd), generator=gen, device="cuda"),
                                    bits)
        vpay, vsc = ref.quant_kv_page(torch.randn((6, t, kv, hd), generator=gen, device="cuda"),
                                      bits)
        return dict(k_pages=pay, k_scales=sc, v_pages=vpay, v_scales=vsc,
                    page_table=torch.randint(0, 6, (b, mp), generator=gen, device="cuda",
                                             dtype=torch.int32),
                    n_pages=torch.tensor(n_valid, dtype=torch.int32, device="cuda"), bits=bits)

    pools = {"warm": pool(8, [4, 0]), "cold": pool(4, [2, 5])}
    host = dict(summary=torch.randn((5, kv, hd), generator=gen, device="cuda"),
                table=torch.randint(0, 5, (b, 3), generator=gen, device="cuda",
                                    dtype=torch.int32),
                n=torch.tensor([2, 3], dtype=torch.int32, device="cuda"), page_tokens=t)
    q = torch.randn((b, h, hd), generator=gen, device="cuda")
    rk = torch.randn((b, r, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    rv = torch.randn((b, r, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    rlen = torch.tensor([r, 0], dtype=torch.int32, device="cuda")
    try:
        ops.use_fused(True)
        f_out, f_hot = ops.tiered_decode_attention(q, pools, rk, rv, rlen, with_telemetry=True,
                                                   host=host)
        ops.use_fused(False)
        before = build.launch_counts()["paged_quant_attention"]
        p_out, p_hot = ops.tiered_decode_attention(q, pools, rk, rv, rlen, with_telemetry=True,
                                                   host=host)
        assert build.launch_counts()["paged_quant_attention"] - before == 2
    finally:
        ops.use_fused(True)
    torch.testing.assert_close(p_out, f_out, **TOL)
    for k in f_hot:
        torch.testing.assert_close(p_hot[k], f_hot[k], **TOL, msg=lambda m: f"{k}: {m}")


@pytest.mark.parametrize("shape", [(4, 16, 4, 64), (3, 16, 32, 64), (2, 8, 2, 128),
                                   (2, 4, 3, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cxl_encode_pages_byte_equal(gen, shape, dtype):
    """Payload, scales and line widths byte-equal to the plain version and
    the payload and scales to quant_pages(., 8); pages whose later lines
    are tiny against the row amax narrow to 4 bits."""
    x = torch.randn(shape, generator=gen, device="cuda")
    x[0, ..., 64:] *= 1e-3
    x = x.to(dtype)
    before = build.launch_counts()["cxl_encode_pages"]
    got = cxl_line.cxl_encode_pages(x)
    want = ref.cxl_encode_kv_page(x)
    assert build.launch_counts()["cxl_encode_pages"] - before == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    qp, qs = quant_page.quant_pages(x, 8)
    assert torch.equal(got[0], qp) and torch.equal(got[1], qs)
    bits = got[2]
    assert bits.shape == shape[:-1] + (shape[-1] // 64,)
    assert bool((bits[1:].amax(dim=-1) == 8).all())  # the line holding the row amax
    if shape[-1] > 64:
        assert bool((bits[0, ..., 1:] == 4).all())


@pytest.mark.parametrize("shape", [(4, 16, 4, 64), (3, 16, 32, 64), (2, 8, 2, 16),
                                   (5, 16, 20, 128)])
def test_cxl_decode_pages_bit_equal(gen, shape):
    pay, sc = ref.quant_kv_page(torch.randn(shape, generator=gen, device="cuda"), 8)
    before = build.launch_counts()["cxl_decode_pages"]
    got = cxl_line.cxl_decode_pages(pay, sc)
    assert build.launch_counts()["cxl_decode_pages"] - before == 1
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.cxl_decode_kv_page(pay, sc))
    assert torch.equal(got, dequant_page.dequant_pages(pay, sc, 8, torch.float32))


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cxl_decode_pages_edge_codes(gen, hd):
    """The row-group dequant step at int8 -> f32, at the head dims the cxl
    codec takes: ragged row counts, all-zero rows, codes +-127 and -128,
    scales over 2^-20 to 2^20 and 0; byte-equal to the plain version and to
    ``dequant_pages``, one launch a call."""
    for rows in (1, 37, 1031):
        q = torch.randint(-128, 128, (rows, hd), generator=gen, device="cuda", dtype=torch.int32)
        q[:, 0], q[:, 1], q[:, -1] = 127, -127, -128
        q[::5] = 0
        sc = torch.exp2(torch.randint(-20, 20, (rows,), generator=gen, device="cuda")
                        .float()) * torch.rand(rows, generator=gen, device="cuda")
        sc[::4] = 0
        sc[::5] = 1  # an all-zero row's scale, as quant gives it
        pay, sc = q.to(torch.int8).reshape(rows, 1, 1, hd), sc.reshape(rows, 1, 1)
        before = build.launch_counts()["cxl_decode_pages"]
        got = cxl_line.cxl_decode_pages(pay, sc)
        assert build.launch_counts()["cxl_decode_pages"] - before == 1
        assert got.dtype == torch.float32 and torch.equal(got, ref.cxl_decode_kv_page(pay, sc))
        assert torch.equal(got, dequant_page.dequant_pages(pay, sc, 8, torch.float32)), rows


def test_cxl_decode_pages_rejects_misaligned_views(gen):
    """A contiguous, pair-aligned payload view off the 4-byte code vectors
    of the dequant geometry raises ValueError (no narrower path)."""
    pay, sc = quant_page.quant_pages(torch.randn((3, 16, 2, 64), generator=gen,
                                                 device="cuda"), 8)
    flat = torch.zeros(pay.numel() + 2, dtype=torch.int8, device="cuda")
    view = flat[2:].view(pay.shape)
    view.copy_(pay)
    assert view.is_contiguous() and view.data_ptr() % 4 == 2
    with pytest.raises(ValueError, match="aligned"):
        cxl_line.cxl_decode_pages(view, sc)


def test_kernels_at_zamba2_width(gen):
    """Every kernel at the zamba2 page shape [., 16, 32, 64] with H = KV =
    32 (the attention kernels' split block: 32 heads x 4 chunks of 16 values
    x 4 token groups, 512 threads)."""
    t, kv, hd, h, b, r, mp = 16, 32, 64, 32, 2, 32, 9
    x = torch.randn((14, t, kv, hd), generator=gen, device="cuda")
    for bits in (8, 4):
        kp, ks = quant_page.quant_pages(x, bits)
        rp, rs = ref.quant_kv_page(x, bits)
        assert torch.equal(kp, rp) and torch.equal(ks, rs)
        tp, ts = transcode_page.transcode_pages(kp, ks, bits, 12 - bits)
        up, us = ref.transcode_kv_page(kp, ks, bits, 12 - bits)
        assert torch.equal(tp, up) and torch.equal(ts, us)
        for out_dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(dequant_page.dequant_pages(kp, ks, bits, out_dtype),
                               dequant_page.dequant_pages_plain(kp, ks, bits, out_dtype))
    enc = cxl_line.cxl_encode_pages(x)
    assert all(torch.equal(g, w) for g, w in zip(enc, ref.cxl_encode_kv_page(x)))
    assert torch.equal(cxl_line.cxl_decode_pages(enc[0], enc[1]),
                       ref.cxl_decode_kv_page(enc[0], enc[1]))

    k8, s8k = ref.quant_kv_page(x[:7], 8)
    v8, s8v = ref.quant_kv_page(x[7:], 8)
    k4, s4k = ref.quant_kv_page(x[:7] * 0.5, 4)
    v4, s4v = ref.quant_kv_page(x[7:] * 0.5, 4)
    summary = torch.randn((4, kv, hd), generator=gen, device="cuda")
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
    rk = torch.randn((b, r, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    rv = torch.randn((b, r, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    codes = torch.tensor([pa.TIER_INT8, pa.TIER_INT4, pa.TIER_HOST, pa.TIER_INVALID],
                         device="cuda")
    tier = codes[torch.randint(0, 4, (b, 3 * mp), generator=gen, device="cuda")].to(torch.int32)
    rows = torch.where(tier == pa.TIER_HOST, 4, 7)
    slot = (torch.rand((b, 3 * mp), generator=gen, device="cuda") * rows).to(torch.int32)
    rlen = torch.tensor([r, 5], dtype=torch.int32, device="cuda")
    args = (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv, slot, tier, rlen, t)
    for g, w in zip(pa.fused_tiered_attention(*args), pa.fused_tiered_attention_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)
    table = torch.randint(0, 7, (b, mp), generator=gen, device="cuda", dtype=torch.int32)
    n = torch.tensor([mp, 3], dtype=torch.int32, device="cuda")
    for pool in ((k8, s8k, v8, s8v, 8), (k4, s4k, v4, s4v, 4)):
        pargs = (q,) + pool[:4] + (table, n, pool[4])
        for g, w in zip(pa.paged_quant_attention(*pargs), ref.paged_quant_attention(*pargs)):
            torch.testing.assert_close(g, w, **TOL)


def _split_operands(gen, b, t, kv, h, hd, ms, n_valid, rlen, r=32):
    """A unified table of ``ms`` columns per sequence (int8, int4 and host
    thirds) whose valid rows are the first ``n_valid[i]`` of each third,
    with stale slots behind TIER_INVALID codes, at the engine's page shape."""
    dev = "cuda"

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    p8 = p4 = 48
    k8, s8k = ref.quant_kv_page(rn(p8, t, kv, hd), 8)
    v8, s8v = ref.quant_kv_page(rn(p8, t, kv, hd) * 0.5, 8)
    k4, s4k = ref.quant_kv_page(rn(p4, t, kv, hd), 4)
    v4, s4v = ref.quant_kv_page(rn(p4, t, kv, hd) * 0.5, 4)
    summary = rn(16, kv, hd)
    q = rn(b, h, hd).to(torch.bfloat16)
    rk, rv = rn(b, r, kv, hd).to(torch.bfloat16), rn(b, r, kv, hd).to(torch.bfloat16)
    third = ms // 3
    slot = torch.zeros((b, ms), dtype=torch.int32, device=dev)
    tier = torch.full((b, ms), pa.TIER_INVALID, dtype=torch.int32, device=dev)
    for i in range(b):
        nw, nc, nh = n_valid[i % len(n_valid)]
        for j, (n, code, rows) in enumerate(((nw, pa.TIER_INT8, p8), (nc, pa.TIER_INT4, p4),
                                             (nh, pa.TIER_HOST, 16))):
            lo = j * third
            slot[i, lo:lo + third] = torch.randint(0, rows, (third,), generator=gen, device=dev,
                                                   dtype=torch.int32)
            tier[i, lo:lo + n] = code
    rl = torch.tensor([rlen[i % len(rlen)] for i in range(b)], dtype=torch.int32, device=dev)
    return (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv, slot, tier, rl, t)


def _assert_split_matches(args):
    """Fused and per-pool kernels against their plain versions at 2e-4, and
    each launched twice on the same inputs with byte-equal outputs."""
    got = pa.fused_tiered_attention(*args)
    again = pa.fused_tiered_attention(*args)
    want = pa.fused_tiered_attention_plain(*args)
    for name, g, a, w in zip(("out", "m", "l", "mass", "base"), got, again, want):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"fused {name}: {m}")
        assert torch.equal(g, a), f"fused {name}: two launches differ"
    q, k8, s8k, v8, s8v, k4, s4k, v4, s4v = args[:9]
    slot, tier = args[12], args[13]
    for bits, code, pool in ((8, pa.TIER_INT8, (k8, s8k, v8, s8v)),
                             (4, pa.TIER_INT4, (k4, s4k, v4, s4v))):
        n = (tier == code).sum(dim=1).to(torch.int32)
        table = slot[:, :64].contiguous()
        # The valid prefix of this codec's third, then stale rows.
        third = slot.shape[1] // 3
        lo = 0 if bits == 8 else third
        table[:, :third] = slot[:, lo:lo + third]
        pargs = (q,) + pool + (table, n, bits)
        got = pa.paged_quant_attention(*pargs)
        again = pa.paged_quant_attention_launch(*pargs)
        want = ref.paged_quant_attention(*pargs)
        for name, g, a, w in zip(("out", "m", "l", "mass", "base"), got, again, want):
            torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"int{bits} {name}: {m}")
            assert torch.equal(g, a), f"int{bits} {name}: two launches differ"


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("t, kv, h, hd", [(16, 20, 20, 128), (16, 32, 32, 64)])
def test_split_attention_long_tables(gen, b, t, kv, h, hd):
    """The cluster split at the engines' page shapes on 96-column tables
    (64-row per-pool tables): every rank of the cluster gets rows, the
    kernels match their plain versions and are deterministic."""
    args = _split_operands(gen, b, t, kv, h, hd, 96, [(20, 30, 6), (3, 32, 12), (32, 9, 0)],
                           [32, 17, 0])
    _assert_split_matches(args)
    s = pa.LAST_CLUSTER["fused_tiered_attention"]
    assert 1 <= s <= 16
    work = int(((args[13] >= 0) & (args[13] <= 2)).sum(dim=1).min())
    assert work >= s, f"a rank of the {s}-block cluster got no row"
    assert pa.LAST_CLUSTER["paged_quant_attention"] >= 1


@pytest.mark.parametrize("case", ["empty_stripes", "all_host", "recent_len_zero", "gqa",
                                  "gqa6", "gqa16"])
def test_split_attention_edges(gen, case):
    """Ranks with no work (3 valid rows over a 96-column table), a sequence
    that sees host sentinels only, an empty recent window, and GQA with
    H = 64, KV = 8 (qwen3_32b, command_r_35b), H = 48, KV = 8
    (internlm2_20b, dbrx_132b) and H = 64, KV = 4 (qwen3_moe_235b, group
    16)."""
    t, kv, h, hd, b = 16, 20, 20, 128, 2
    n_valid, rlen = [(20, 30, 6), (3, 32, 12)], [32, 5]
    if case == "empty_stripes":
        n_valid, rlen = [(1, 1, 1), (0, 2, 0)], [0, 0]
    elif case == "all_host":
        n_valid, rlen = [(0, 0, 32), (0, 0, 7)], [0, 9]
    elif case == "recent_len_zero":
        rlen = [0, 0]
    else:
        kv, h = {"gqa": (8, 64), "gqa6": (8, 48), "gqa16": (4, 64)}[case]
    _assert_split_matches(_split_operands(gen, b, t, kv, h, hd, 96, n_valid, rlen))


def test_wrappers_reject_bad_operands(gen):
    x = torch.randn((2, 8, 2, 32), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        quant_page.quant_pages(x.to(torch.float16), 8)
    with pytest.raises(ValueError):
        quant_page.quant_pages(x.transpose(1, 2), 8)
    p, s = quant_page.quant_pages(x, 8)
    with pytest.raises(ValueError):
        transcode_page.transcode_pages(p, s.cpu(), 8, 4)
    with pytest.raises(ValueError):
        dequant_page.dequant_pages(p, s.cpu(), 8)
    with pytest.raises(TypeError):
        dequant_page.dequant_pages(p, s, 8, torch.float16)
    with pytest.raises(ValueError, match="multiple"):
        cxl_line.cxl_encode_pages(x)  # head_dim 32: not whole 64-codeword lines
    with pytest.raises(TypeError):
        cxl_line.cxl_decode_pages(p.view(torch.uint8), s)
    with pytest.raises(ValueError):
        cxl_line.cxl_decode_pages(p, s.cpu())


def test_cache_paths_on_the_gpu_match_the_cpu(gen):
    """The cache's batched executor and per-page path with the kernels on
    the GPU: the same placements and byte-equal payloads as the plain
    versions on the CPU."""
    import numpy as np

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.serving.kv_cache import TieredKVCache

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)

    def make(device):
        return TieredKVCache(cfg, 2, 2, 8, 64, 16, ManagerConfig(policy="analytical"),
                             warm_frac=0.25, device=device)

    caches = {"cuda": make("cuda"), "cpu": make("cpu")}
    rng = np.random.default_rng(0)
    coords = [(la, sl, pg) for la in range(2) for sl in range(2) for pg in range(6)]
    k = torch.from_numpy(rng.normal(0, 1, (len(coords), 8, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (len(coords), 8, 2, 16)).astype(np.float32))
    rids = np.arange(0, 32, 3)  # 2 layers x 2 slots x 8 pages; pages 6-7 never exist
    dsts = np.array([(1, 2, 3, 4)[i % 4] for i in range(rids.size)], np.int64)
    for c in caches.values():
        dev = c.device
        c.append_pages(coords, k.to(dev), v.to(dev))  # warm pressure: batched demotion
        c.migrate_batch(rids, dsts)
        for r in rids[:6]:
            c.migrate(int(r), 2 if c.physical[r] != 2 else 3)
        c.append_page(0, 1, 7, k[0].to(dev), v[0].to(dev))  # per-page eviction path
    a, b = caches["cuda"], caches["cpu"]
    np.testing.assert_array_equal(a.physical, b.physical)
    assert set(a.host_pages) == set(b.host_pages)
    for f in ("c8_k", "c8_k_scales", "c4_v", "c4_v_scales", "host_summary", "warm_table",
              "cold_n", "host_table"):
        assert torch.equal(getattr(a.state, f).cpu(), getattr(b.state, f)), f
    for r in a.host_pages:
        for x, y in zip(a.host_pages[r], b.host_pages[r]):
            np.testing.assert_array_equal(x, y)


def test_async_pipeline_on_the_gpu_matches_the_cpu(gen):
    """The async pipeline with the cache on the GPU (pinned ring, device
    cohorts, the transcode and dequant kernels) against the same cache on
    the CPU: the same placements, host payloads, sentinel centroids and
    pipeline counters, a clean ring, and the kernels really launched."""
    import numpy as np

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.media.faults import FaultEvent, FaultPlan
    from repro_torch.serving.kv_cache import TieredKVCache

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)
    plan = FaultPlan([FaultEvent(k, d, 1, 99) for k in ("transient", "corrupt")
                      for d in ("hbm", "host_dram_pcie")])

    def make(device):
        return TieredKVCache(cfg, 2, 2, 8, 64, 16, ManagerConfig(policy="analytical", alpha=0.1),
                             warm_frac=0.5, async_migration=True, ring_slots=8, prefetch=True,
                             fault_plan=plan, device=device)

    caches = {"cuda": make("cuda"), "cpu": make("cpu")}
    assert caches["cuda"].staging_ring.buf.is_pinned()
    rng = np.random.default_rng(0)
    coords = [(la, sl, pg) for la in range(2) for sl in range(2) for pg in range(8)]
    k = torch.from_numpy(rng.normal(0, 1, (len(coords), 8, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (len(coords), 8, 2, 16)).astype(np.float32))
    before = build.launch_counts()
    for c in caches.values():
        c.append_pages(coords, k.to(c.device), v.to(c.device))
        for w in range(4):
            counts = np.zeros(c.n_regions)
            counts[np.arange(w, c.n_regions, 3)] = 500.0
            c.manager.record_access_counts(counts)
            for _ in range(6):
                if c.pipeline.busy:
                    c.pipeline.tick()
                else:
                    c.prefetch_tick()
            c.end_window()
        c.drain_migrations()
    launched = {n: build.launch_counts()[n] - before[n] for n in before}
    a, b = caches["cuda"], caches["cpu"]
    np.testing.assert_array_equal(a.physical, b.physical)
    assert a.pipeline.pages_moved == b.pipeline.pages_moved > 0
    for f in ("fault_retries", "corruptions_detected", "prefetch_staged", "prefetch_hits"):
        assert getattr(a.pipeline, f) == getattr(b.pipeline, f), f
    assert a.pipeline.corruptions_detected > 0
    assert set(a.host_pages) == set(b.host_pages)
    for r in a.host_pages:
        for x, y in zip(a.host_pages[r], b.host_pages[r]):
            np.testing.assert_array_equal(x, y)
    for f in ("c8_k", "c4_v", "c4_v_scales", "host_summary", "warm_table", "host_n"):
        assert torch.equal(getattr(a.state, f).cpu(), getattr(b.state, f)), f
    assert a.staging_ring.held_slots == 0
    assert launched["transcode_pages"] > 0 and launched["dequant_pages"] > 0


# ---------------------------------------------------------------------------
# Preemption to the host tier, the frontend and the SSM family on the GPU
# (SMOKE size; the CPU parity tests hold the same paths to the JAX package)
# ---------------------------------------------------------------------------

SMOKE_GEOM = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)


def _smoke_engine(model, params, device, window_steps=10_000):
    from repro_torch.configs import TierScapeRunConfig
    from repro_torch.serving.engine import TieredEngine

    ts = TierScapeRunConfig(enabled=True, policy="analytical", window_steps=window_steps)
    return TieredEngine(model, params, ts=ts, device=device, **SMOKE_GEOM)


def _smoke_model(arch, device):
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model

    model = Model(get_smoke(arch), device=device)
    return model, model.init(0)


def _slot_table_rows(cache, slot):
    """Logical pages of ``slot``'s rows per (pool, layer), in table order."""
    import numpy as np

    from repro_torch.serving.kv_cache import COLD, HOST4, HOST8, WARM

    out = {}
    for pool, levels, owner in (("warm", (WARM,), cache._pool_slot),
                                ("cold", (COLD,), cache._pool_slot),
                                ("host", (HOST8, HOST4), cache._host_slot)):
        table = getattr(cache.state, f"{pool}_table").cpu().numpy()
        count = getattr(cache.state, f"{pool}_n").cpu().numpy()
        for layer in range(cache.la):
            rids = [cache.rid(layer, slot, p) for p in range(cache.max_pages)]
            lookup = {int(owner[r]): r % cache.max_pages for r in rids
                      if cache._page_exists[r] and int(cache.physical[r]) in levels}
            out[pool, layer] = [lookup[int(x)]
                                for x in table[layer, slot, :int(count[layer, slot])]]
    return out


def preempt_resume_case(device):
    """Uninterrupted vs preempted-after-5-steps (the vacated slot churned by
    another request, resume into the other slot): tokens, zero re-prefill,
    and the resumed slot's table rows in the uninterrupted run's order."""
    import numpy as np

    model, params = _smoke_model("qwen1_5_4b", device)
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, 256, 24).astype(np.int32)
    other = rng.integers(1, 256, 12).astype(np.int32)
    ea = _smoke_engine(model, params, device)
    ra = ea.make_request(prompt, 20)
    ea.start_request(0, ra)
    snap = None
    for i in range(100):
        if ra.done:
            break
        if i == 5:
            snap = _slot_table_rows(ea.cache, 0)
        ea.step()
    eb = _smoke_engine(model, params, device)
    rb = eb.make_request(prompt, 20)
    eb.start_request(0, rb)
    for _ in range(5):
        eb.step()
    pre = eb.preempt_slot(0)
    o = eb.make_request(other, 6)
    eb.start_request(0, o)
    while not o.done:
        eb.step()
    eb.resume_into(1, pre)
    restored = _slot_table_rows(eb.cache, 1)
    while not rb.done:
        eb.step()
    stats = eb.finish()
    assert rb.out_tokens == ra.out_tokens
    assert restored == snap
    assert stats.re_prefill_tokens == 0 and stats.resumes == 1
    assert stats.resumed_pages == len(pre.parked.pages) > 0
    assert pre.parked.recent_k.device.type == "cpu"


def park_restore_case(device):
    """After park the slot is empty everywhere; after restore its rids,
    placements and table rows are the pre-preemption ones."""
    import numpy as np

    model, params = _smoke_model("qwen1_5_4b", device)
    eng = _smoke_engine(model, params, device)
    prompt = np.random.default_rng(13).integers(1, 256, 40).astype(np.int32)
    eng.start_request(0, eng.make_request(prompt, 4))
    cache = eng.cache
    rids, rows = cache.slot_rids(0), _slot_table_rows(cache, 0)
    phys = cache.physical[rids].copy()
    pre = eng.preempt_slot(0)
    assert cache.slot_rids(0).size == 0
    for f in ("warm_n", "cold_n", "host_n"):
        assert int(getattr(cache.state, f)[:, 0].sum()) == 0, f
    assert int(cache.state.recent_len[0]) == 0 and int(cache.state.total_len[0]) == 0
    eng.resume_into(0, pre)
    assert np.array_equal(cache.slot_rids(0), rids)
    assert np.array_equal(cache.physical[rids], phys)
    assert _slot_table_rows(cache, 0) == rows
    assert int(cache.state.total_len[0]) == int(eng.slot_len[0])


def scheduler_failover_case(device):
    """Two replicas sharing one set of weights, the burst trace of the
    reference's scheduler test, replica 0 hard-failing at step 20: every
    request done or refused with its full token count, zero re-prefill."""
    from repro_torch.frontend import ContinuousScheduler, TraceConfig, generate

    model, params = _smoke_model("qwen1_5_4b", device)
    events = generate(TraceConfig(
        kind="burst", steps=60, rate=0.10, seed=3, sla_mix=(0.85, 0.15), burst_every=24,
        burst_len=4, burst_mult=8.0, burst_sla=1, prompt_len=(10, 18), new_tokens=(8, 14),
        n_tenants=2, tenant_mix=(0.8, 0.2), tenant_flip_step=30))
    engines = [_smoke_engine(model, params, device, window_steps=16) for _ in range(2)]
    before = build.launch_counts()
    stats = ContinuousScheduler(engines, events, 256, prefill_chunk_tokens=8).run(
        max_steps=600, failures={20: 0})
    assert len(stats.done()) + stats.refused == len(events)
    for rec in stats.done():
        assert len(rec.token_steps) == rec.event.max_new_tokens == len(rec.request.out_tokens)
        assert (rec.tbt() >= 1).all()
    assert stats.re_prefill_tokens == 0
    assert stats.replica_failures == 1 and stats.failover_parked >= 1
    assert stats.preemptions >= 1 and stats.resumes >= 1
    if device == "cuda":
        fused = build.launch_counts()["fused_tiered_attention"] - before["fused_tiered_attention"]
        assert fused == sum(e.stats.attn_launches for e in engines) > 0


def mamba2_decode_case(device):
    """The mamba2 SMOKE: decode over 45 tokens (not a multiple of the SSD
    chunk) against the parallel forward at the reference's bar of 0.15."""
    model, params = _smoke_model("mamba2_780m", device)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, 256, (2, 45), generator=g).to(device)
    full = model.forward(params, {"tokens": tokens})[0]
    state = model.init_cache(2, 47)
    outs = []
    for i in range(tokens.shape[1]):
        lg, state = model.decode_step(params, tokens[:, i: i + 1], state)
        outs.append(lg)
    assert torch.isfinite(full).all()
    assert float((full.float() - torch.cat(outs, 1).float()).abs().max()) < 0.15


def test_preempt_resume_bit_identical_on_the_gpu(gen):
    preempt_resume_case("cuda")


def test_park_restore_table_invariants_on_the_gpu(gen):
    park_restore_case("cuda")


def test_scheduler_failover_on_the_gpu(gen):
    scheduler_failover_case("cuda")


def test_mamba2_decode_matches_forward_on_the_gpu(gen):
    mamba2_decode_case("cuda")


def test_moe_ffn_is_deterministic_on_the_gpu(gen):
    """One full-width qwen3_moe_235b MoE layer (128 experts, top 8, d_model
    4096) on the card: two calls on the same inputs give byte-equal outputs
    and aux, at a prefill shape whose capacity drops tokens and at the
    tiered step's decode shape (capacity 4, nothing dropped)."""
    from repro_torch.configs import get
    from repro_torch.models import moe

    cfg = get("qwen3_moe_235b")
    p = moe.init_moe_params(gen, cfg, device="cuda")
    for shape in ((1, 600), (2, 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen, device="cuda").to(torch.bfloat16)
        a, aux_a = moe.moe_ffn(p, cfg, x)
        b, aux_b = moe.moe_ffn(p, cfg, x)
        torch.cuda.synchronize()
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        assert torch.equal(a, b), shape
        assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a), shape
        plan = moe.route(p, cfg, x)
        assert plan["capacity"] == (48 if shape[1] == 600 else 4)
        if shape[1] == 1:
            assert float(aux_a["dropped_frac"]) == 0.0


# ---------------------------------------------------------------------------
# the training path on the card
# ---------------------------------------------------------------------------


def _train_steps(device, opt):
    """Two steps of the qwen1_5_4b SMOKE (bf16) on one batch: AdamW at
    tests/test_archs.py's lr, or tiered Adam under ``default_policy``."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.models.inputs import make_train_batch
    from repro_torch.optim import adamw, tiered_adam
    from repro_torch.runtime.train import make_train_step

    model, params = _smoke_model("qwen1_5_4b", device)
    batch = make_train_batch(model.cfg, batch=2, seq=32, device=device)
    policy = tiered_adam.default_policy(params) if opt == "tiered" else None
    state = tiered_adam.init(params, policy) if policy else adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-3), ParallelConfig(), batch,
                           tiered_policy=policy).fn
    losses = []
    for _ in range(2):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return params, state, losses


@pytest.mark.parametrize("opt", ["adamw", "tiered"])
def test_smoke_train_step_descends_on_the_gpu(gen, opt):
    """Two steps on one batch descend on the card, the parameters stay bf16
    on the card, and no kernel of the serving path is launched."""
    import numpy as np

    before = build.launch_counts()
    params, state, losses = _train_steps("cuda", opt)
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses
    assert params["embed"].dtype == torch.bfloat16 and params["embed"].is_cuda
    assert build.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_wire_backward_on_the_gpu_equals_the_cpu(gen, dtype):
    """The int8 wire's backward (the round trip of the cotangent) on the
    card equals its CPU run on the same cotangent, bit for bit, at a
    full-width qwen3_moe_235b dispatch shape [B, E, C, D]."""
    from repro_torch.models import moe

    shape = (2, 128, 40, 4096)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    outs = []
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).requires_grad_(True)
        y = moe.make_wire_transfer()(xd)
        (gx,) = torch.autograd.grad(y, xd, g.to(dev))
        outs.append((y.detach().cpu(), gx.cpu()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert float(outs[0][1].float().abs().max()) > 0


def test_checkpoint_round_trip_of_gpu_tensors_is_bit_equal(gen, tmp_path):
    """A trained SMOKE's params and tiered Adam state (bf16, f32, int8,
    scales, an int32 0-d step) saved asynchronously from the card restore
    onto the card bit for bit."""
    from repro_torch import pytree
    from repro_torch.checkpoint import CheckpointManager

    params, state, _ = _train_steps("cuda", "tiered")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"params": params, "opt": state}, blocking=False)
    example = pytree.tree_map(torch.zeros_like, {"params": params, "opt": state})
    step, out = mgr.restore(example)
    assert step == 2 and out["opt"].policy == state.policy
    def raw(t):
        return t.detach().cpu().reshape(-1).view(torch.uint8)

    for a, b in zip(pytree.leaves(out), pytree.leaves({"params": params, "opt": state})):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(raw(a), raw(b))


# ---------------------------------------------------------------------------
# the serving example's geometry, the dense serve steps and the sp attention
# ---------------------------------------------------------------------------


def _t8_operands(gen, b, h, kv, hd, t=8, r=16, mp=9):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    k8, s8k = ref.quant_kv_page(rn(11, t, kv, hd), 8)
    v8, s8v = ref.quant_kv_page(rn(11, t, kv, hd), 8)
    k4, s4k = ref.quant_kv_page(rn(10, t, kv, hd), 4)
    v4, s4v = ref.quant_kv_page(rn(10, t, kv, hd), 4)
    summary = rn(6, kv, hd)
    q = rn(b, h, hd).to(torch.bfloat16)
    rk, rv = rn(b, r, kv, hd).to(torch.bfloat16), rn(b, r, kv, hd).to(torch.bfloat16)
    codes = torch.tensor([pa.TIER_INT8, pa.TIER_INT4, pa.TIER_HOST, pa.TIER_INVALID],
                         device="cuda")
    tier = codes[torch.randint(0, 4, (b, 3 * mp), generator=gen, device="cuda")].to(torch.int32)
    rows = torch.where(tier == pa.TIER_INT8, 11, torch.where(tier == pa.TIER_INT4, 10, 6))
    slot = (torch.rand((b, 3 * mp), generator=gen, device="cuda") * rows).to(torch.int32)
    return q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv, slot, tier


@pytest.mark.parametrize("kv, h, hd", [(32, 32, 64), (20, 20, 128)])
def test_kernels_at_the_serving_example_geometry(gen, kv, h, hd):
    """The serving example's engine (``page_tokens=8``, ``recent_window=16``)
    at zamba2_1_2b's and qwen1_5_4b's head shapes: the fused kernel cuts the
    recent window into T/2-token chunks, so every fill of the 16-token
    window (0, odd, one chunk, full) is held to the plain version; the page
    kernels on [., 8, KV, hd] pages byte-equal."""
    b, r = 4, 16
    ops_ = _t8_operands(gen, b, h, kv, hd)
    for fill in ([0, 1, 4, 16], [5, 8, 15, 3], [16, 16, 16, 16]):
        rlen = torch.tensor(fill, dtype=torch.int32, device="cuda")
        args = ops_ + (rlen, 8)
        got = pa.fused_tiered_attention(*args)
        want = pa.fused_tiered_attention_plain(*args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
    x = torch.randn((13, 8, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    for bits in (8, 4):
        kp, ks = quant_page.quant_pages(x, bits)
        rp, rs = ref.quant_kv_page(x, bits)
        assert torch.equal(kp, rp) and torch.equal(ks, rs)
        tp, ts = transcode_page.transcode_pages(kp, ks, bits, 12 - bits)
        up, us = ref.transcode_kv_page(kp, ks, bits, 12 - bits)
        assert torch.equal(tp, up) and torch.equal(ts, us)
        for out_dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(dequant_page.dequant_pages(kp, ks, bits, out_dtype),
                               dequant_page.dequant_pages_plain(kp, ks, bits, out_dtype))


@pytest.mark.parametrize("bits", [8, 4])
def test_sp_pool_attention_on_the_gpu(gen, bits):
    """One device: one per-pool launch and the merge, byte-equal to the
    per-pool kernel. Two model shards in turn (an abstract (1, 2) mesh, the
    pages striped over them): against the plain version of the unsharded
    pool with global slot positions, within the attention bar."""
    from repro_torch.launch.mesh import make_abstract_mesh, make_mesh
    from repro_torch.runtime import serve

    b, h, kv, hd, t, mp, rows = 4, 20, 20, 128, 8, 8, 6
    x = torch.randn((2, 2 * rows, t, kv, hd), generator=gen, device="cuda")
    kp, ks = ref.quant_kv_page(x[0], bits)
    vp, vs = ref.quant_kv_page(x[1], bits)
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
    table = torch.randint(0, 2 * rows, (b, mp), generator=gen, device="cuda").to(torch.int32)
    n = torch.tensor([0, 2, 4, mp], dtype=torch.int32, device="cuda")
    pool = {"k_pages": kp, "k_scales": ks, "v_pages": vp, "v_scales": vs,
            "page_table": table, "n_pages": n}
    one = serve.make_sp_pool_attention(make_mesh((1, 1), ("data", "model")), ("data",))
    before = build.launch_counts()["paged_quant_attention"]
    got = one(q, pool, bits)
    assert build.launch_counts()["paged_quant_attention"] == before + 1
    want = pa.paged_quant_attention(q, kp, ks, vp, vs, table, n, bits)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    # Two shards: global page g on shard g % 2 at local row g // 2.
    phys = torch.cat([torch.arange(0, 2 * rows, 2), torch.arange(1, 2 * rows, 2)]).cuda()
    cols = mp // 2
    shard_of_col = (torch.arange(mp, device="cuda") // cols)[None]
    striped = (table // 2) * 2 + shard_of_col
    sharded = {"k_pages": kp[phys], "k_scales": ks[phys], "v_pages": vp[phys],
               "v_scales": vs[phys], "page_table": striped.to(torch.int32), "n_pages": n}
    two = serve.make_sp_pool_attention(make_abstract_mesh((1, 2), ("data", "model")), ("data",))
    out, m, lsum, mass, base = two(q, sharded, bits)
    torch.cuda.synchronize()
    for j in range(2):
        sl = slice(j * cols, (j + 1) * cols)
        pos = torch.arange(j * cols, (j + 1) * cols, dtype=torch.int32, device="cuda")
        w = ref.paged_quant_attention(q, kp, ks, vp, vs, striped[:, sl].contiguous(), n, bits,
                                      slot_pos=pos[None].expand(b, cols))
        torch.testing.assert_close(mass[:, sl], w[3], **TOL)
        torch.testing.assert_close(base[:, sl], w[4], **TOL)
    w = ref.paged_quant_attention(q, kp, ks, vp, vs, striped, n, bits)
    live = w[2] > 0
    torch.testing.assert_close((out / lsum.clamp_min(1e-30)[..., None])[live],
                               (w[0] / w[2].clamp_min(1e-30)[..., None])[live], **TOL)
    torch.testing.assert_close((m + lsum.log())[live], (w[1] + w[2].log())[live], **TOL)


def test_dense_decode_step_on_the_gpu_matches_the_cpu(gen):
    """``make_prefill_step`` and 4 steps of ``make_decode_step`` on the
    qwen1_5_4b SMOKE: the card against the CPU on the same weights, within
    tests/test_torch_model.py's logits bar."""
    from repro_torch import pytree
    from repro_torch.configs import ParallelConfig, get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.runtime import serve

    outs = {}
    cfg = get_smoke("qwen1_5_4b")
    cpu_params = Model(cfg, device="cpu").init(0)
    tokens = torch.randint(1, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        params = pytree.tree_map(lambda t: t.to(dev), cpu_params)
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        fn, _ = serve.make_prefill_step(model, mesh, ParallelConfig())
        logits = [fn(params, {"tokens": tokens.to(dev)}).float().cpu()]
        step = serve.make_decode_step(model, mesh, ParallelConfig(), 2, 32)
        state = model.init_cache(2, 32)
        for i in range(4):
            lg, state = step.fn(params, tokens[:, i:i + 1].to(dev), state)
            logits.append(lg.float().cpu())
        outs[dev] = logits
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0.0625)


# ------------------------------------------------ the captured decode step
GRAPH_ARCHS = ["qwen1_5_4b", "qwen3_32b", "qwen3_moe_235b", "qwen2_vl_72b", "zamba2_1_2b"]


def _graph_engine(arch, window_steps=5):
    """A SMOKE engine on the card at alpha 0.1 (warm, cold and host pages)
    with two requests prefilled; its step is the captured one."""
    import numpy as np

    from repro_torch.configs import TierScapeRunConfig
    from repro_torch.serving.engine import TieredEngine

    model, params = _smoke_model(arch, "cuda")
    ts = TierScapeRunConfig(enabled=True, policy="analytical", alpha=0.1,
                            window_steps=window_steps)
    eng = TieredEngine(model, params, ts=ts, device="cuda", **SMOKE_GEOM)
    rng = np.random.default_rng(1)
    for n in (40, 27):
        eng.submit(rng.integers(1, model.cfg.vocab_size, n), max_new_tokens=24)
    eng._fill_slots()
    return eng


def _same_step(got, want, what):
    import dataclasses

    from repro_torch.runtime.serve import TieredKVState

    (lg, tg, eg, hg), (lw, tw, ew, hw) = got, want
    assert torch.equal(lg, lw), what
    for k in hw:
        assert torch.equal(hg[k], hw[k]), (what, k)
    for f in dataclasses.fields(TieredKVState):
        assert torch.equal(getattr(tg, f.name), getattr(tw, f.name)), (what, f.name)
    for a, b in zip(eg or (), ew or ()):
        assert torch.equal(a, b), what


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_replay_matches_the_eager_kernel_step(gen, arch):
    """Every engine step (captured once, then replayed over page-outs and
    window-boundary migrations) byte-equal to the eager step on the
    same inputs; outputs never alias the graph's static buffers."""
    from repro_torch.runtime import serve

    eng = _graph_engine(arch)
    graphed = eng._step_fn
    eager = serve.make_tiered_decode_step(eng.model, eng.ts, device="cuda")
    seen = []

    def checked(params, token, tkv, extra):
        got = graphed(params, token, tkv, extra)
        want = eager(params, token, tkv, extra)
        _same_step(got, want, f"{arch} step {len(seen)}")
        g = graphed.graphs["fused"]
        static = {t.data_ptr() for t in g.produced(g.out)}
        assert not static & {got[0].data_ptr(), got[1].recent_k.data_ptr()}
        seen.append(1)
        return got

    eng._step_fn = checked
    for _ in range(14):
        eng._fill_slots()
        eng.step()
    torch.cuda.synchronize()
    assert eng.stats.migrations > 0 and eng.stats.windows >= 2
    assert graphed.captures == {"fused": 1} and graphed.replays == len(seen) - 1 == 13


def test_graph_recaptures_on_route_change_and_moved_buffer(gen):
    """A route change captures the other route once; a class buffer that
    moved is captured again, never replayed at its old address; each
    result equals the eager kernel step's on the same route."""
    import dataclasses

    from repro_torch.runtime import serve
    from repro_torch.runtime.graph import route

    eng = _graph_engine("qwen1_5_4b")
    graphed = eng._step_fn
    eager = serve.make_tiered_decode_step(eng.model, eng.ts, device="cuda")

    def step_and_check():
        tok = torch.ones((eng.bs, 1), dtype=torch.int64, device="cuda")
        st = eng.cache.state
        _same_step(graphed(eng.params, tok, st, None), eager(eng.params, tok, st, None), route())

    for _ in range(2):
        step_and_check()
    try:
        ops.use_fused(False)
        for _ in range(2):
            step_and_check()
    finally:
        ops.use_fused(True)
    step_and_check()
    assert graphed.captures == {"fused": 1, "per_pool": 1} and graphed.replays == 3
    st = eng.cache.state
    eng.cache.state = dataclasses.replace(st, c8_k=st.c8_k.clone(), host_summary=st.host_summary
                                          .clone())
    del st
    step_and_check()
    step_and_check()
    assert graphed.captures == {"fused": 2, "per_pool": 1} and graphed.replays == 4


@pytest.mark.parametrize("fused", [True, False])
def test_graph_replay_counts_launches_and_skips_host_checks(gen, fused, monkeypatch):
    """A capture counts no launch; each replay counts the launches its graph
    holds (one fused launch a layer, or one per-pool launch per pool and
    layer), as the cache bills them; the class-bounds check runs on eager
    steps only, never in a replay; the cluster size stays as captured."""
    eng = _graph_engine("qwen1_5_4b")
    checks = []
    real = ops._check_class_bounds
    monkeypatch.setattr(ops, "_check_class_bounds", lambda *a: checks.append(1) or real(*a))
    name = "fused_tiered_attention" if fused else "paged_quant_attention"
    per_step = eng.la * (1 if fused else 2)
    try:
        ops.use_fused(fused)
        build.reset_launch_counts()
        eng.step()  # the warm-up step runs eagerly and returns; then the capture
        torch.cuda.synchronize()
        assert build.launch_counts()[name] == per_step
        assert len(checks) == (1 if fused else 0)  # once a step, for every layer
        checks.clear()
        cluster = pa.LAST_CLUSTER[name]
        pa.LAST_CLUSTER[name] = 0
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(6):
                eng.step()
            torch.cuda.synchronize()
    finally:
        ops.use_fused(True)
    counts = build.launch_counts()
    assert counts[name] == 7 * per_step == eng.cache.attn_launches
    # The replays' counts come from the capture's record; the profiler sees
    # the kernels the replays actually ran.
    seen = sum(e.count for e in prof.key_averages() if f"{name}_kernel" in e.key)
    assert seen == 6 * per_step
    assert counts["fused_tiered_attention" if not fused else "paged_quant_attention"] == 0
    assert not checks and pa.LAST_CLUSTER[name] == cluster >= 1
    assert eng._step_fn.replays == 6
    # The glue kernels: two norms a layer and the final one, one QKV
    # epilogue and one SiLU * up a layer, in every step that ran.
    assert counts["rmsnorm"] == 7 * (2 * eng.la + 1)
    assert counts["qkv_epilogue"] == counts["silu_mul"] == 7 * eng.la
    for kernel in ("rmsnorm_kernel", "qkv_epilogue_kernel", "silu_mul_kernel"):
        seen = sum(e.count for e in prof.key_averages() if kernel in e.key)
        assert seen * 7 == 6 * counts[kernel[:-len("_kernel")]], kernel


# ------------------------------------------------ the decode step's glue kernels
GLUE_ARCHS = ["qwen1_5_4b", "qwen3_32b"]  # 20 MHA heads with QKV biases; 64/8 GQA, qk-norm
EPILOGUE_ARCHS = GLUE_ARCHS + ["qwen2_vl_72b"]  # and M-RoPE, whose cos and sin it takes too


def _one_ulp_apart(got, want) -> bool:
    """Every bf16 value of ``got`` within one ulp of ``want`` (8
    significant bits), the larger value's ulp."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((g - w).abs() <= ulp).all())


def _glue_inputs(gen, arch, b):
    from repro_torch.configs import get

    cfg = get(arch)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)

    return cfg, rnd


@pytest.mark.parametrize("arch", GLUE_ARCHS)
@pytest.mark.parametrize("b", [2, 6])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_within_one_ulp(gen, arch, b, dtype):
    """One launch a call; from the plain version within one bf16 ulp, and
    in f32 within ``assert_close``'s f32 default (only the sum of squares is
    in another order, which moves an f32 result by a few ulps)."""
    from repro_torch.kernels import decode_glue

    cfg, rnd = _glue_inputs(gen, arch, b)
    x = rnd(b, 1, cfg.d_model, scale=3.0).to(dtype)
    w = 1 + 0.1 * torch.randn(cfg.d_model, generator=gen, device="cuda")
    before = build.launch_counts()["rmsnorm"]
    got = decode_glue.rmsnorm(w, x, cfg.norm_eps)
    assert build.launch_counts()["rmsnorm"] - before == 1
    want = decode_glue.rmsnorm_plain(w, x, cfg.norm_eps)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.bfloat16:
        assert _one_ulp_apart(got, want)
    else:
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("arch", EPILOGUE_ARCHS)
@pytest.mark.parametrize("b", [2, 6])
def test_qkv_epilogue_kernel_matches_plain(gen, arch, b):
    """Biases, qk-norm and RoPE (M-RoPE's for ``qwen2_vl_72b``) at the
    cells' widths: q, and the k and v rows written, within one bf16 ulp of
    the plain version; every other row of the windows byte-equal, and
    nothing written for a slot whose row is at or beyond the window."""
    from repro_torch.kernels import decode_glue
    from repro_torch.runtime import serve

    cfg, rnd = _glue_inputs(gen, arch, b)
    h, kv, hd, r = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_(), 32
    q, k, v = rnd(b, 1, h, hd), rnd(b, 1, kv, hd), rnd(b, 1, kv, hd)
    bias = (rnd(h, hd, scale=0.5), rnd(kv, hd, scale=0.5), rnd(kv, hd, scale=0.5))
    norms = tuple(1 + 0.1 * torch.randn(hd, generator=gen, device="cuda") for _ in range(2))
    total_len = torch.tensor([257 + 911 * i for i in range(b)], dtype=torch.int32, device="cuda")
    cos, sin = serve.step_rope(cfg, total_len, "cuda")
    rows = [5, r, 0, 31, r + 7, 17][:b]  # a slot at the window's end and one beyond it
    recent_len = torch.tensor(rows, dtype=torch.int32, device="cuda")
    window = (rnd(b, r, kv, hd), rnd(b, r, kv, hd))
    got_w, want_w = [w.clone() for w in window], [w.clone() for w in window]
    args = dict(bias=bias if cfg.qkv_bias else None, qk_norm=norms if cfg.qk_norm else None,
                eps=cfg.norm_eps)
    before = build.launch_counts()["qkv_epilogue"]
    got = decode_glue.qkv_epilogue(q, k, v, cos, sin, *got_w, recent_len, **args)
    assert build.launch_counts()["qkv_epilogue"] - before == 1
    want = decode_glue.qkv_epilogue_plain(q, k, v, cos, sin, *want_w, recent_len, **args)
    assert got.shape == q.shape and _one_ulp_apart(got, want)
    for g, w, old in zip(got_w, want_w, window):
        for i, row in enumerate(rows):
            other = [j for j in range(r) if j != row]
            assert torch.equal(g[i, other], old[i, other]), (i, row)
            if row < r:
                assert _one_ulp_apart(g[i, row], w[i, row]) and not torch.equal(g[i, row],
                                                                                 old[i, row])
            else:
                assert torch.equal(g[i], old[i])


@pytest.mark.parametrize("arch", GLUE_ARCHS)
@pytest.mark.parametrize("b", [2, 6])
def test_silu_mul_kernel_matches_plain(gen, arch, b):
    """SiLU(gate) * up at the cells' FFN widths: one launch, within one
    bf16 ulp of the plain version (the same f32 ops and ``expf``)."""
    from repro_torch.kernels import decode_glue

    cfg, rnd = _glue_inputs(gen, arch, b)
    gate, up = rnd(b, 1, cfg.d_ff, scale=4.0), rnd(b, 1, cfg.d_ff)
    before = build.launch_counts()["silu_mul"]
    got = decode_glue.silu_mul(gate, up)
    assert build.launch_counts()["silu_mul"] - before == 1
    want = decode_glue.silu_mul_plain(gate, up)
    assert got.shape == gate.shape and _one_ulp_apart(got, want)


@pytest.mark.parametrize("arch", EPILOGUE_ARCHS)
def test_captured_glue_step_matches_the_eager_plain_step(gen, arch):
    """The engine's captured step on the card (the first call captures, the
    next replay) against the same step built on the CPU and run eagerly on
    CPU copies of the params and the state, where every wrapper runs its
    plain version: logits within the model tests' bar, hotness within
    kernel #1's 2e-4, the windows' untouched rows equal."""
    import dataclasses

    from repro_torch import pytree
    from repro_torch.models import Model
    from repro_torch.runtime import serve

    eng = _graph_engine(arch)
    graphed = eng._step_fn
    plain = serve.make_tiered_decode_step(Model(eng.model.cfg, device="cpu"), eng.ts,
                                          device="cpu")
    params = pytree.tree_map(lambda t: t.cpu(), eng.params)
    for i in range(3):
        tok = torch.full((eng.bs, 1), 3 + i, dtype=torch.int64, device="cuda")
        st = eng.cache.state
        on_cpu = dataclasses.replace(st, **{f.name: getattr(st, f.name).cpu()
                                            for f in dataclasses.fields(st)})
        lg, tkv, _, hot = graphed(eng.params, tok, st, None)
        lw, tkw, _, hw = plain(params, tok.cpu(), on_cpu, None)
        torch.testing.assert_close(lg.float().cpu(), lw.float(), rtol=0, atol=0.0625)
        for k in ("warm", "cold", "host"):
            torch.testing.assert_close(hot[k].cpu(), hw[k], rtol=2e-4, atol=2e-4)
        assert torch.equal(tkv.recent_len.cpu(), tkw.recent_len)
        # The windows differ only in the row each slot wrote.
        r = st.recent_k.shape[2]
        kept = (torch.arange(r)[None] != on_cpu.recent_len[:, None].long())
        for f in ("recent_k", "recent_v"):
            assert torch.equal(getattr(tkv, f).cpu()[:, kept], getattr(on_cpu, f)[:, kept])
            assert torch.equal(getattr(tkw, f)[:, kept], getattr(on_cpu, f)[:, kept])
    assert graphed.replays == 2 and sum(graphed.captures.values()) == 1
