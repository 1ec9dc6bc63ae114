"""The row-group requantization kernels' rules, on the CPU.

``csrc/row_group.cuh`` (kernels #2 ``quant_pages`` and #3
``transcode_pages``) replaces the per-element IEEE divide by a multiply with
the row's reciprocal scale wherever that provably rounds alike, and divides
only within 2^-15 of a rounding tie. Here that rule is modelled in numpy
float32 (IEEE round-to-nearest, subnormals kept, as the card computes without
fast math) and held to ``clamp(rint(x / scale))`` on a million seeded rows
and on constructed tie neighbourhoods. The kernels' geometry
(``kernels/row_group.py``) is checked for every even head_dim the wrappers
take, and the engine's bf16 page-out (``append_pages`` on the KV cache's own
bf16) against the same pages upcast to f32, and against the JAX cache fed
f32 as the reference engine does. The dequant step (kernel #4) and the cxl
encode's line widths (kernel #6) are modelled too: codes to floats by their
bits under 2^23 and one f32 multiply, bit-equal to ``ref.dequant_kv_page``
on every code; which lanes hold which 64-code line and the segmented max,
equal to ``ref.cxl_encode_kv_page``'s widths. The kernels themselves run on
the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dequant_page, ref  # noqa: E402
from repro_torch.kernels.row_group import (SRC_BITS, dequant_geometry, line_geometry,  # noqa: E402
                                           row_geometry)

F32 = np.float32
TIE_GUARD = F32(0.5) - F32(2.0 ** -15)
RINT_MAGIC = F32(1.5 * 2 ** 23)


def _scales(amax: np.ndarray, qmax: float) -> np.ndarray:
    """int4.cuh's quant_scale: amax / qmax by IEEE divide, 1 where amax = 0."""
    return np.where(amax == 0, F32(1), amax / F32(qmax)).astype(F32)


def _clamp(n: np.ndarray, qmax: float) -> np.ndarray:
    """fminf(fmaxf(n, -qmax), qmax): a NaN clamps to -qmax, as on the card."""
    return np.fmin(np.fmax(n, -qmax), qmax)


def exact_codes(x: np.ndarray, scale: np.ndarray, qmax: float) -> np.ndarray:
    """int4.cuh's quantize(): clamp(rint(x / scale), +-qmax)."""
    with np.errstate(all="ignore"):
        return _clamp(np.rint(x / scale[:, None]), qmax)


def guarded_codes(x: np.ndarray, scale: np.ndarray, qmax: float):
    """row_group.cuh's fast_codes, element for element: y = x * rcp(scale)
    and t = y + 1.5 * 2^23 rounded once each, the code t's low bits (no
    clamp); where |y - (t - 1.5 * 2^23)| is not below 0.5 - 2^-15 (NaN
    included) exact_codes takes over with quantize(). Returns the codes and
    where the exact path was taken."""
    with np.errstate(all="ignore"):
        rcp = (F32(1) / scale).astype(F32)
        y = (x * rcp[:, None]).astype(F32)
        t = (y + RINT_MAGIC).astype(F32)
        d = (y - (t - RINT_MAGIC).astype(F32)).astype(F32)
        exact = ~(np.abs(d) < TIE_GUARD)
        fast = (t.view(np.int32).astype(np.int64) - 0x4B400000).astype(F32)
    return np.where(exact, exact_codes(x, scale, qmax), fast), exact


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest even) and back, as the KV cache holds it."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _random_rows(rng, n: int, hd: int, qmax: float):
    """Rows as the kernels meet them: f32 and bf16 activations over 2^-60 to
    2^60, all-zero rows, rows of subnormal magnitude (1/scale overflows),
    and transcode rows (codes of the other width times their old scale)."""
    x = rng.standard_normal((n, hd)).astype(F32)
    x *= np.exp2(rng.uniform(-60, 60, (n, 1))).astype(F32)
    kind = rng.integers(0, 8, n)
    x[kind == 1] = _bf16(x[kind == 1])
    x[kind == 2] = 0
    x[kind == 3] *= F32(2.0 ** -100) * F32(2.0 ** -40)
    codes = rng.integers(-127 if qmax == 7 else -8, 128 if qmax == 7 else 8, (n, hd))
    old = np.exp2(rng.uniform(-20, 4, (n, 1))).astype(F32)
    x[kind >= 6] = (codes.astype(F32) * old)[kind >= 6]
    return x, kind


def _tie_rows(rng, qmax: float):
    """Rows whose first element sets the scale (amax = qmax * s) and whose
    others sit 0-4 ulps around every (k + 0.5) * s, around (qmax - 0.5) * s
    and just under amax: where a reciprocal multiply flips rint."""
    rows = []
    for s in np.exp2(rng.uniform(-30, 10, 400)).astype(F32):
        amax = F32(qmax) * s
        cands = [(F32(k) + F32(0.5)) * s for k in np.arange(-qmax, qmax)]
        cands += [(F32(qmax) - F32(0.5)) * s, amax]
        near = []
        for c in cands:
            for d in range(-4, 5):
                v = c
                for _ in range(abs(d)):
                    v = np.nextafter(v, F32(np.inf) if d > 0 else F32(-np.inf), dtype=F32)
                if abs(v) <= amax:
                    near.append(v)
        near = np.asarray(near, F32)
        for i in range(0, near.size, 31):
            chunk = near[i:i + 31]
            rows.append(np.concatenate([[amax], chunk, np.zeros(31 - chunk.size, F32)]))
    return np.stack(rows).astype(F32)


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_guarded_reciprocal_equals_ieee_divide_on_random_rows(qmax):
    rng = np.random.default_rng(15 + int(qmax))
    n_rows, n_act, taken, worst = 0, 0, 0, 0.0
    for _ in range(8):
        x, kind = _random_rows(rng, 1 << 17, 16, qmax)
        scale = _scales(np.abs(x).max(axis=1), qmax)
        got, exact = guarded_codes(x, scale, qmax)
        np.testing.assert_array_equal(got, exact_codes(x, scale, qmax))
        with np.errstate(all="ignore"):
            rcp = (F32(1) / scale).astype(F32)
            y = (x * rcp[:, None]).astype(F32)
            q = (x / scale[:, None]).astype(F32)
        normal = np.isfinite(rcp) & (scale > 0)
        worst = max(worst, float(np.abs(y - q)[normal].max()))
        n_rows += x.shape[0]
        act = normal & (kind < 6)
        n_act += int(act.sum()) * x.shape[1]
        taken += int(exact[act].sum())
    assert n_rows >= 10 ** 6
    # The header's bound: y and fl(x / scale) within 3.0001 u |q| <= 2.3e-5.
    assert worst <= 2.3e-5
    # On activations the exact path is rare. Rows of subnormal magnitude
    # (the scale underflows or its reciprocal overflows) take it throughout,
    # and transcoded rows meet true ties often (int4 -> int8: q = c * 127 / 8
    # is a half-integer for c = +-4, -8).
    assert taken < 1e-3 * n_act


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_guarded_reciprocal_equals_ieee_divide_at_ties(qmax):
    rng = np.random.default_rng(7)
    x = _tie_rows(rng, qmax)
    scale = _scales(np.abs(x).max(axis=1), qmax)
    got, exact = guarded_codes(x, scale, qmax)
    want = exact_codes(x, scale, qmax)
    np.testing.assert_array_equal(got, want)
    assert exact.any()
    # Without the guard the reciprocal multiply flips ties: the guard is what
    # keeps the kernels byte-equal.
    with np.errstate(all="ignore"):
        y = (x * (F32(1) / scale).astype(F32)[:, None]).astype(F32)
    assert (_clamp(np.rint(y), qmax) != want).any()


def test_guarded_reciprocal_on_nonfinite_and_tiny_inputs():
    """inf and NaN elements and scales whose reciprocal overflows take the
    exact path and give quantize()'s codes."""
    x = np.array([[np.inf, 1.0, -2.0, 0.0], [np.nan, 1.0, 0.5, -0.25],
                  [1e-45, -1e-45, 0.0, 7e-46], [3e-39, -1.5e-39, 7.5e-40, 0.0],
                  [-np.inf, np.inf, 0.0, 1.0]], F32)
    for qmax in (127.0, 7.0):
        scale = _scales(np.array([np.inf, 1.0, 1e-45, 3e-39, np.inf], F32), qmax)
        got, _ = guarded_codes(x, scale, qmax)
        want = exact_codes(x, scale, qmax)
        np.testing.assert_array_equal(got, want)


def test_transcode_amax_from_the_largest_code():
    """row_group.cuh's lane_amax for transcode rows: the max of fabsf(q *
    os) over a row equals fmaxf(0, RN(max |q| * |os|)) for every old scale,
    zero, negative, subnormal, inf and NaN included (fmaxf skips NaN)."""
    rng = np.random.default_rng(2)
    q = rng.integers(-128, 128, (20000, 16)).astype(F32)
    q[::7] = 0
    q[1::7, 3] = -128
    os = np.exp2(rng.uniform(-149, 127, 20000)).astype(F32) * rng.choice([-1, 1], 20000)
    os[:6] = [0.0, np.inf, -np.inf, np.nan, 1e-45, 3.4e38]
    with np.errstate(all="ignore"):
        x = np.abs((q * os[:, None]).astype(F32))
        per_element = np.fmax.reduce(np.concatenate([np.zeros((20000, 1), F32), x], 1), axis=1)
        from_max = np.fmax(F32(0), (np.abs(q).max(axis=1) * np.abs(os)).astype(F32))
    np.testing.assert_array_equal(per_element, from_max)


def _kernel_cover(geo, rows: int, k: int) -> np.ndarray:
    """How often the kernel's thread map (row_group.cuh: batch b, row slot
    k, group g, lane j, vector v -> row (b K + k) (256 / G) + g, chunk
    v G + j) touches each (row, chunk)."""
    groups = 256 // geo.lanes
    batches = -(-rows // (groups * k))
    b, kk, g, j, v = np.meshgrid(np.arange(batches), np.arange(k), np.arange(groups),
                                 np.arange(geo.lanes), np.arange(geo.vectors), indexing="ij")
    row = (b * k + kk) * groups + g
    chunk = v * geo.lanes + j
    ok = (row < rows) & (chunk < geo.chunks)
    hits = np.zeros((rows, geo.chunks), np.int64)
    np.add.at(hits, (row[ok], chunk[ok]), 1)
    return hits


@pytest.mark.parametrize("src", sorted(SRC_BITS))
@pytest.mark.parametrize("dst_bits", [8, 4])
def test_row_geometry_for_every_head_dim(src, dst_bits):
    pair = 2 * SRC_BITS[src] // 8
    for hd in range(2, 257, 2):
        geo = row_geometry(hd, src, dst_bits)
        row_bytes = hd * SRC_BITS[src] // 8
        vb = geo.vec_bytes
        assert vb in (1, 2, 4, 8, 16) and pair <= vb and row_bytes % vb == 0, (hd, geo)
        # The widest vector the row allows.
        assert vb == 16 or row_bytes % (2 * vb), (hd, geo)
        assert geo.chunks == row_bytes // vb
        assert geo.lanes in (1, 2, 4, 8, 16, 32)
        assert geo.lanes >= min(geo.chunks, 32) and geo.lanes // 2 < geo.chunks
        assert geo.vectors in (1, 2, 4) and geo.lanes * geo.vectors >= geo.chunks
        assert geo.vectors == 1 or geo.lanes * geo.vectors // 2 < geo.chunks
        assert geo.rows_per_batch * geo.vectors == 4
        elems = vb * 8 // SRC_BITS[src]
        assert elems % 2 == 0 and geo.out_bytes * 8 == elems * dst_bits
        assert geo.out_align in (1, 2, 4, 8, 16)
    # The serving shapes load 16-byte vectors.
    for hd in (64, 128):
        assert row_geometry(hd, src, dst_bits).vec_bytes == 16
    for bad in (0, 3, 258):
        with pytest.raises(ValueError, match="head_dim"):
            row_geometry(bad, src, dst_bits)


@pytest.mark.parametrize("hd, src", [(16, "f32"), (128, "bf16"), (64, "int8"), (34, "int4"),
                                     (256, "f32"), (250, "bf16")])
def test_kernel_thread_map_covers_each_chunk_once(hd, src):
    """Ragged row counts (1, 7, 33, 320) at every rows-per-batch the launcher
    may take: each (row, chunk) is loaded and stored by exactly one lane."""
    geo = row_geometry(hd, src, 4 if src != "int4" else 8)
    for rows in (1, 7, 33, 320):
        for k in (1, 2, 4):
            if k <= geo.rows_per_batch:
                assert (_kernel_cover(geo, rows, k) == 1).all(), (rows, k, geo)


def _append_run(cache, coords, k, v):
    cache.append_pages(coords, k, v)
    live = np.where(cache._page_exists)[0]
    # A plan over what was paged out, so the pages move through the tiers.
    cache.migrate_batch(live[::3], np.full(live[::3].size, 4, np.int64))
    cache.migrate_batch(live[1::3], np.full(live[1::3].size, 2, np.int64))
    return cache


def _port_cache(cfg, device="cpu"):
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.serving.kv_cache import TieredKVCache

    return TieredKVCache(cfg, 2, 2, 16, 256, 32, ManagerConfig(policy="analytical"),
                         warm_frac=0.25, device=device)


def test_append_pages_bf16_equals_f32_upcast():
    """The engine's page-out hands ``append_pages`` the KV cache's bf16; the
    same pages upcast to f32 (what the engine handed before, and what the
    JAX engine quantizes) give byte-equal payloads, scales, placements and
    host sentinels, with warm pressure and a migration plan on top."""
    import jax.numpy as jnp

    from repro.configs import get_smoke as j_smoke
    from repro.core.manager import ManagerConfig as JManagerConfig
    from repro.serving.kv_cache import TieredKVCache as JCache
    from repro_torch.configs import get_smoke

    cfg = get_smoke("qwen1_5_4b")
    rng = np.random.default_rng(3)
    coords = [(la, sl, pg) for la in range(2) for sl in range(2) for pg in range(12)]
    shape = (len(coords), 16, cfg.n_kv_heads, cfg.head_dim_())
    kb = torch.from_numpy(rng.standard_normal(shape).astype(F32)).to(torch.bfloat16)
    vb = torch.from_numpy(rng.standard_normal(shape).astype(F32) * 0.5).to(torch.bfloat16)
    a = _append_run(_port_cache(cfg), coords, kb, vb)
    b = _append_run(_port_cache(cfg), coords, kb.float(), vb.float())
    np.testing.assert_array_equal(a.physical, b.physical)
    np.testing.assert_array_equal(a.manager.placement, b.manager.placement)
    for f in ("c8_k", "c8_k_scales", "c8_v", "c8_v_scales", "c4_k", "c4_k_scales", "c4_v",
              "c4_v_scales", "host_summary", "warm_table", "cold_table", "host_table",
              "warm_n", "cold_n", "host_n"):
        x, y = getattr(a.state, f), getattr(b.state, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert set(a.host_pages) == set(b.host_pages) and a.host_pages
    for r in a.host_pages:
        for x, y in zip(a.host_pages[r], b.host_pages[r]):
            np.testing.assert_array_equal(x, y)

    # The JAX cache, fed the f32 upcast as its engine does: the same
    # placements; pages within the reference's own bars (tests/test_kernels.py:
    # scales to rtol 1e-6, dequantized values within one quant step, since
    # its jitted quant flips round-half-even ties against the IEEE divide).
    j = JCache(j_smoke("qwen1_5_4b"), 2, 2, 16, 256, 32, JManagerConfig(policy="analytical"),
               warm_frac=0.25)
    j.append_pages(coords, jnp.asarray(kb.float().numpy()), jnp.asarray(vb.float().numpy()))
    live = np.where(j._page_exists)[0]
    j.migrate_batch(live[::3], np.full(live[::3].size, 4, np.int64))
    j.migrate_batch(live[1::3], np.full(live[1::3].size, 2, np.int64))
    np.testing.assert_array_equal(a.physical, j.physical)
    assert set(a.host_pages) == set(j.host_pages)
    for r in a.host_pages:
        bits = 8 if a.physical[r] == 3 else 4
        x, y = a.host_pages[r], [torch.from_numpy(np.asarray(h)) for h in j.host_pages[r]]
        for i in (0, 2):
            np.testing.assert_allclose(x[i + 1], y[i + 1].numpy(), rtol=1e-6)
            step = torch.from_numpy(x[i + 1])[..., None]
            diff = (ref.dequant_kv_page(torch.from_numpy(x[i]), torch.from_numpy(x[i + 1]), bits)
                    - ref.dequant_kv_page(y[i], y[i + 1], bits)).abs()
            assert bool((diff <= step * (1 + 1e-6)).all()), r


# -- the dequant step (kernel #4) and the cxl encode's line widths (kernel #6)

@pytest.mark.parametrize("src", ["int8", "int4"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_dequant_geometry_for_every_head_dim(src, out):
    pair = 2 * SRC_BITS[src] // 8
    for hd in range(2, 257, 2):
        geo = dequant_geometry(hd, src, out)
        row_bytes = hd * SRC_BITS[src] // 8
        vb = geo.vec_bytes
        cap = 16 * SRC_BITS[src] // (32 if out == "f32" else 16)  # the codes of 16 B out
        assert vb in (1, 2, 4, 8) and pair <= vb <= cap and row_bytes % vb == 0, (hd, geo)
        assert vb == cap or row_bytes % (2 * vb), (hd, geo)  # the widest the row allows
        assert geo.chunks == row_bytes // vb
        assert geo.lanes in (1, 2, 4, 8, 16, 32)
        assert geo.lanes >= min(geo.chunks, 32) and geo.lanes // 2 < geo.chunks
        assert geo.vectors in (1, 2, 4) and geo.lanes * geo.vectors >= geo.chunks
        assert geo.vectors == 1 or geo.lanes * geo.vectors // 2 < geo.chunks
        assert geo.rows_per_batch * geo.vectors == 4
        # The values a vector becomes, stored in whole 32-bit words.
        elems = vb * 8 // SRC_BITS[src]
        assert geo.out_bytes == elems * (4 if out == "f32" else 2)
        assert geo.out_bytes % 4 == 0 and geo.out_align in (4, 8, 16)
    for hd in (16, 32, 64, 128, 256):  # the serving shapes store 16-byte vectors
        assert dequant_geometry(hd, src, out).out_bytes == 16
    for bad in (0, 3, 258):
        with pytest.raises(ValueError, match="head_dim"):
            dequant_geometry(bad, src, out)
    with pytest.raises(ValueError, match="no dequant"):
        dequant_geometry(64, "bf16", out)


@pytest.mark.parametrize("hd, src, out", [(128, "int4", "f32"), (64, "int4", "f32"),
                                          (128, "int8", "bf16"), (34, "int8", "f32"),
                                          (250, "int4", "bf16"), (2, "int8", "f32")])
def test_dequant_thread_map_covers_each_chunk_once(hd, src, out):
    """The dequant step runs the requantization step's thread map
    (``rows_kernel``): each (row, chunk) is loaded and stored by exactly one
    lane at ragged row counts and every rows-per-batch."""
    geo = dequant_geometry(hd, src, out)
    for rows in (1, 7, 33, 320):
        for k in (1, 2, 4):
            if k <= geo.rows_per_batch:
                assert (_kernel_cover(geo, rows, k) == 1).all(), (rows, k, geo)


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_dequant_geometry_at_the_cxl_decode_shapes(hd):
    """Kernel #7 ``cxl_decode_pages`` runs the dequant step at int8 -> f32
    on the cxl codec's head dims (multiples of 64; the cache passes 64 or
    128): a lane loads 4 codes and stores 16 bytes, a row group covers a
    row, each (row, chunk) is touched once at the zamba2 run's largest HOST8
    read (19 x 16 x 32 rows), and each warp-wide store writes contiguous
    bytes, 512 of them where the row fills its lanes' vectors."""
    geo = dequant_geometry(hd, "int8", "f32", "cxl_decode_pages")
    assert (geo.vec_bytes, geo.out_bytes, geo.out_align) == (4, 16, 16)
    assert geo.chunks == hd // 4 and geo.lanes == min(hd // 4, 32)
    assert geo.lanes * geo.vectors >= geo.chunks and geo.rows_per_batch * geo.vectors == 4
    rows, groups = 19 * 16 * 32, 256 // geo.lanes
    for k in (1, 2, 4):
        if k > geo.rows_per_batch:
            continue
        assert (_kernel_cover(geo, rows, k) == 1).all(), k
        for warp in range(256 // 32):
            lane = np.arange(32) + 32 * warp
            g, j = lane // geo.lanes, lane % geo.lanes
            for kk in range(k):
                for v in range(geo.vectors):
                    chunk = v * geo.lanes + j
                    ok = chunk < geo.chunks
                    off = np.sort(((kk * groups + g) * geo.chunks + chunk)[ok] * geo.out_bytes)
                    assert (np.diff(off) == geo.out_bytes).all(), (k, warp, kk, v)
                    assert off.size * geo.out_bytes == 512 or geo.chunks % 32, (k, warp, kk, v)


def _line_widths_model(codes: np.ndarray, lg) -> np.ndarray:
    """row_group.cuh's line widths, lane by lane: lane j of vector slot v
    holds chunk v G + j (zeros past the chunks) and its max |code|; a
    segmented xor-shuffle max over lanes_per_line lanes; the segment's first
    lane stores 4 (max <= 7) or 8 for line (v G + j) // lanes_per_line, if
    the chunk lies in the row. Returns [rows, lines] (-1 where no lane
    stored, 2 if two did)."""
    geo, L = lg.row, lg.lanes_per_line
    rows = codes.shape[0]
    per_chunk = np.abs(codes.astype(np.int32)).reshape(rows, geo.chunks, -1).max(axis=2)
    lane_max = np.zeros((rows, geo.vectors, geo.lanes), np.int32)
    stores = np.zeros((rows, lg.lines), np.int64)
    for v in range(geo.vectors):
        for j in range(geo.lanes):
            c = v * geo.lanes + j
            if c < geo.chunks:
                lane_max[:, v, j] = per_chunk[:, c]
    o = L // 2
    while o:
        lane_max = np.maximum(lane_max, lane_max[:, :, np.arange(geo.lanes) ^ o])
        o //= 2
    out = np.full((rows, lg.lines), -1, np.int64)
    for v in range(geo.vectors):
        for j in range(0, geo.lanes, L):
            line = lg.line_of(v, j)
            if line is not None:
                out[:, line] = np.where(lane_max[:, v, j] <= 7, 4, 8)
                stores[:, line] += 1
    return np.where(stores == 1, out, np.where(stores == 0, -1, 2))


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
@pytest.mark.parametrize("src", ["bf16", "f32"])
def test_cxl_line_layout_model_equals_plain_line_widths(hd, src):
    """Which lanes hold which line and the segmented max, modelled on the
    codes of random pages (lines narrowed by scaling, zero rows), give the
    plain version's line widths at every head_dim the encode takes."""
    lg = line_geometry(hd, src)
    assert lg.lanes_per_line == (8 if src == "bf16" else 16)
    assert lg.row.vec_bytes == 16 and lg.row.chunks % lg.lanes_per_line == 0
    assert lg.row.lanes >= lg.lanes_per_line  # a line never leaves its row group
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((3000, 1, 1, hd)).astype(F32)
    narrow = rng.choice([1, 0.05, 0.02], (3000, 1, 1, hd // 64)).astype(F32).repeat(64, -1)
    narrow[..., :64] = 1  # the first line keeps the row's amax
    x *= narrow
    x[::7] = 0
    pages = torch.from_numpy(x).to(torch.bfloat16 if src == "bf16" else torch.float32)
    payload, _, want = ref.cxl_encode_kv_page(pages)
    got = _line_widths_model(payload.reshape(3000, hd).numpy(), lg)
    np.testing.assert_array_equal(got, want.reshape(3000, -1).numpy())
    assert (got == 4).any() and (got == 8).any()
    # Lanes past the chunks (hd 192: 24 chunks of bf16 on 32 lanes, or f32's
    # second vector slot) hold no line and store none.
    holders = {(v, j) for v in range(lg.row.vectors) for j in range(lg.row.lanes)
               if lg.line_of(v, j) is not None}
    assert len(holders) == lg.row.chunks
    for bad in (32, 320):
        with pytest.raises(ValueError, match="multiple"):
            line_geometry(bad, src)


def _elements_model(codes: np.ndarray, bits: int) -> np.ndarray:
    """row_group.cuh's Elements<I8/I4>: a code c becomes the f32 of bits
    0x4B000000 | (c + bias) (PRMT or a nibble mask), minus 2^23 + bias."""
    bias = 128 if bits == 8 else 8
    raw = (codes.astype(np.int64) + bias).astype(np.uint32) | np.uint32(0x4B000000)
    return (raw.view(F32) - F32(2 ** 23 + bias)).astype(F32)


def _bf16_rne_model(y: np.ndarray) -> np.ndarray:
    """__floats2bfloat162_rn: round f32 to bf16, nearest even (NaN stays
    NaN), returned as f32."""
    b = y.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16).astype(np.uint32).view(F32)
    return np.where(np.isnan(y), F32(np.nan), r).astype(F32)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_elements_model_bit_equal(bits):
    """Every int8 code (all 256) and every int4 code (all 16, as all 256
    packed bytes) through Elements and one f32 multiply, at 10^4 scales
    (2^-149 to 2^127, both signs, zero, subnormal, inf), bit-equal to
    ``ref.dequant_kv_page`` in f32 and, rounded to bf16, to its cast."""
    rng = np.random.default_rng(16 + bits)
    n = 10 ** 4
    sc = (np.exp2(rng.uniform(-149, 127, n)) * rng.choice([-1, 1], n)).astype(F32)
    sc[:6] = [0.0, -0.0, np.inf, 1e-45, 3.4e38, 1.0]
    byte = np.arange(256, dtype=np.int64)
    if bits == 8:
        payload = np.tile((byte - 128).astype(np.int8), (n, 1))
        codes = payload.astype(np.int64)
    else:
        payload = np.tile(byte.astype(np.uint8), (n, 1))
        nib = np.stack([byte & 0xF, byte >> 4], -1).reshape(-1)
        codes = np.tile(np.where(nib >= 8, nib - 16, nib), (n, 1))
    x = _elements_model(codes, bits)
    np.testing.assert_array_equal(x, codes.astype(F32))  # exact conversion
    with np.errstate(all="ignore"):
        y = (x * sc[:, None]).astype(F32)
    want = ref.dequant_kv_page(torch.from_numpy(payload), torch.from_numpy(sc), bits)
    np.testing.assert_array_equal(y, want.numpy())
    np.testing.assert_array_equal(np.signbit(y), np.signbit(want.numpy()))
    want16 = want.to(torch.bfloat16).float().numpy()
    got16 = _bf16_rne_model(y)
    np.testing.assert_array_equal(got16, want16)
    np.testing.assert_array_equal(np.signbit(got16[~np.isnan(got16)]),
                                  np.signbit(want16[~np.isnan(want16)]))


def test_library_mul_equals_plain_dequant():
    """The yardstick ``chip_smoke.py`` times beside int8 dequant: one
    ``torch.mul`` of the int8 payload and the scales, into f32 by type
    promotion or into a bf16 ``out``, is bit-equal to the plain version."""
    rng = np.random.default_rng(5)
    pay = torch.from_numpy(rng.integers(-128, 128, (40, 16, 4, 64)).astype(np.int8))
    sc = torch.from_numpy((np.exp2(rng.uniform(-30, 30, (40, 16, 4))) * rng.random((40, 16, 4)))
                          .astype(F32))
    f32 = torch.mul(pay, sc[..., None])
    assert f32.dtype == torch.float32
    assert torch.equal(f32, dequant_page.dequant_pages_plain(pay, sc, 8, torch.float32))
    bf16 = torch.empty(pay.shape, dtype=torch.bfloat16)
    torch.mul(pay, sc[..., None], out=bf16)
    assert torch.equal(bf16, dequant_page.dequant_pages_plain(pay, sc, 8, torch.bfloat16))
