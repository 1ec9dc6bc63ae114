"""The port's kernel layer against the JAX package, on the CPU.

The CUDA kernels run only on a GPU (``chip_smoke.py`` and
``test_torch_cuda.py`` hold each one to its plain version there); here every
wrapper takes its plain PyTorch version
because the tensors lie on the CPU, and those plain versions are held to the
JAX Pallas kernels (interpret mode) and ``repro.kernels.ref`` with the
reference's own bars: quant scales within rtol 1e-6 and payloads within one
quantization step (< 2% codes differ), transcode and the int4 layout
byte-equal, dequant equal bit for bit (f32 and bf16 out), fused and per-pool
attention within rtol = atol = 2e-4, and the per-pool ``use_fused(False)``
path equal to the fused one at the bars of ``tests/test_fused_attention.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.dequant_page import dequant_pages as j_dequant  # noqa: E402
from repro.kernels.paged_attention import paged_quant_attention as j_paged  # noqa: E402
from repro.kernels import packing as jpacking  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import fused_tiered_attention as j_fused  # noqa: E402
from repro.kernels.quant_page import quant_pages as j_quant  # noqa: E402
from repro.kernels.transcode_page import transcode_pages as j_transcode  # noqa: E402
from repro_torch.kernels import build, ops, packing, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import dequant_page, quant_page, transcode_page  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402

SWEEP = [
    # (P, T, KV, HD) — tests/test_kernels.py's sweep
    (4, 8, 1, 32),
    (4, 16, 4, 64),
    (8, 32, 2, 128),
    (2, 64, 8, 128),
]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _restore_fused_toggle():
    yield
    ops.use_fused(True)
    jops.use_fused(True)


def _t(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x))


def _n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quant_pages_matches_reference(shape, bits, dtype):
    rng = np.random.default_rng(42)
    x = rng.normal(0, 1, shape).astype(np.float32)
    jpages = jnp.asarray(x, getattr(jnp, dtype))
    tpages = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(_n(jpages), _n(tpages))  # same inputs
    tp, ts = quant_page.quant_pages(tpages, bits)
    for jp_, js_ in (j_quant(jpages, bits), jref.quant_kv_page(jpages, bits)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js_), rtol=1e-6)
        step = float(np.asarray(js_).max())
        np.testing.assert_allclose(
            ref.dequant_kv_page(tp, ts, bits).numpy(),
            np.asarray(jref.dequant_kv_page(jp_, js_, bits)), atol=step + 1e-6,
        )
        assert (tp.numpy() != np.asarray(jp_)).mean() < 0.02
    # The ops dispatch and the oracle agree exactly on the CPU.
    op, os_ = ops.quant_pages(tpages, bits)
    rp, rs = ref.quant_kv_page(tpages, bits)
    assert torch.equal(op, rp) and torch.equal(os_, rs)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("route", [(8, 4), (4, 8)])
def test_transcode_pages_byte_equal(shape, route):
    src, dst = route
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1, shape).astype(np.float32)
    jpay, jsc = jref.quant_kv_page(jnp.asarray(x), src)
    tpay, tsc = _t(jpay), _t(jsc)
    kp, ks = transcode_page.transcode_pages(tpay, tsc, src, dst)
    for rp, rs in (j_transcode(jpay, jsc, src, dst), jref.transcode_kv_page(jpay, jsc, src, dst),
                   jops.transcode_pages(jpay, jsc, src, dst)):
        np.testing.assert_array_equal(kp.numpy(), np.asarray(rp))
        np.testing.assert_allclose(ks.numpy(), np.asarray(rs), rtol=1e-6)
    # Same width is the identity: the inputs come back, no launch.
    ip, isc = ops.transcode_pages(tpay, tsc, src, src)
    assert ip is tpay and isc is tsc


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_dequant_pages_matches_pallas_bit_for_bit(shape, bits, out_dtype):
    rng = np.random.default_rng(13)
    jpay, jsc = jref.quant_kv_page(jnp.asarray(rng.normal(0, 1, shape), jnp.float32), bits)
    want = j_dequant(jpay, jsc, bits, getattr(jnp, out_dtype))
    got = dequant_page.dequant_pages(_t(jpay), _t(jsc), bits, getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_n(got), _n(want))
    np.testing.assert_array_equal(
        _n(ops.dequant_pages(_t(jpay), _t(jsc), bits, getattr(torch, out_dtype))),
        _n(jops.dequant_pages(jpay, jsc, bits, getattr(jnp, out_dtype))))


@pytest.mark.parametrize("kv,heads", [(1, 4), (2, 8), (4, 4), (8, 16)])
@pytest.mark.parametrize("bits", [8, 4])
def test_paged_quant_attention_matches_pallas(kv, heads, bits):
    """tests/test_kernels.py's case: one pool, a full, a one-page and an
    empty sequence (m = 0, l = 0), tails past ``n_pages``."""
    rng = np.random.default_rng(7)
    p, t, hd, b, mp = 6, 16, 64, 3, 4
    pages = jnp.asarray(rng.normal(0, 1, (p, t, kv, hd)), jnp.bfloat16)
    kp, ks = jref.quant_kv_page(pages, bits)
    vp, vs = jref.quant_kv_page(pages * 0.3, bits)
    q = jnp.asarray(rng.normal(0, 1, (b, heads, hd)), jnp.float32)
    table = jnp.asarray(rng.integers(0, p, (b, mp)), jnp.int32)
    n_pages = jnp.asarray([mp, 1, 0], jnp.int32)
    want = j_paged(q, kp, ks, vp, vs, table, n_pages, bits)
    got = pa.paged_quant_attention(*(_t(a) for a in (q, kp, ks, vp, vs, table, n_pages)), bits)
    for field, g, w in zip(("out", "m", "l", "mass", "base"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=field, **TOL)
    assert float(got[1][2].abs().max()) == 0.0 and float(got[2][2].abs().max()) == 0.0
    assert (got[3][1:, 1:].numpy() == 0).all() and (got[4][2].numpy() == pa.NEG_INF).all()


def test_int4_nibble_layout_byte_equal():
    vals = np.array([(a, b) for a in range(-7, 8) for b in range(-7, 8)], np.float32).reshape(-1)
    packed = packing.pack_int4(torch.from_numpy(vals))
    jpacked = jpacking.pack_int4(jnp.asarray(vals))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    all_bytes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        packing.unpack_int4(torch.from_numpy(all_bytes)).numpy(),
        np.asarray(jpacking.unpack_int4(jnp.asarray(all_bytes))),
    )
    # Even index in the low nibble, two's complement.
    assert int(packing.pack_int4(torch.tensor([-1.0, 2.0]))[0]) == 0x2F


# ---------------------------------------------------------------------------
# fused tiered attention (tests/test_fused_attention.py's shapes)
# ---------------------------------------------------------------------------

B, H, KV, HD, T, R = 2, 8, 2, 32, 8, 6


def _mk_pool(rng, n_pages, bits, mp, n_valid):
    pages = jnp.asarray(rng.normal(0, 1, (n_pages, T, KV, HD)), jnp.bfloat16)
    kp, ks = jref.quant_kv_page(pages, bits)
    vp, vs = jref.quant_kv_page(pages * 0.5, bits)
    return dict(
        k_pages=kp, k_scales=ks, v_pages=vp, v_scales=vs,
        page_table=jnp.asarray(rng.integers(0, n_pages, (B, mp)), jnp.int32),
        n_pages=jnp.asarray(n_valid, jnp.int32), bits=bits,
    )


def _mk_host(rng, hs=5, mp=3, n=(2, 3)):
    return dict(
        summary=jnp.asarray(rng.normal(0, 1, (hs, KV, HD)), jnp.float32),
        table=jnp.asarray(rng.integers(0, hs, (B, mp)), jnp.int32),
        n=jnp.asarray(n, jnp.int32), page_tokens=T,
    )


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: (v if k in ("bits", "page_tokens") else _to_port(v)) for k, v in tree.items()}
    return _t(tree)


CASES = {
    # name: (pool specs [(bits, n_valid per seq)], host?, recent_len)
    "mixed": ([(8, (3, 1)), (4, (2, 4))], True, (R, R // 2)),
    "three_tiers": ([(8, (4, 2)), (4, (1, 3)), (8, (2, 0))], True, (R, 2)),
    "recent_len_zero": ([(8, (2, 3)), (4, (3, 1))], True, (0, R)),
    "empty_pools": ([(8, (0, 0)), (4, (0, 0))], True, (R, 1)),
    "all_host": ([], True, (R, 0)),
    "no_host": ([(4, (4, 4))], False, (R, R)),
    # the int4 pool's columns are all past its valid prefix: no column of
    # the unified table holds the int4 tier code
    "int4_class_unheld": ([(8, (3, 2)), (4, (0, 0))], True, (R, 1)),
}


def _case(name):
    rng = np.random.default_rng(7)
    specs, with_host, rlen = CASES[name]
    pools = {f"t{i}": _mk_pool(rng, 6, bits, 4, nv) for i, (bits, nv) in enumerate(specs)}
    host = _mk_host(rng) if with_host else None
    q = jnp.asarray(rng.normal(0, 1, (B, H, HD)), jnp.float32)
    rk = jnp.asarray(rng.normal(0, 1, (B, R, KV, HD)), jnp.bfloat16)
    rv = jnp.asarray(rng.normal(0, 1, (B, R, KV, HD)), jnp.bfloat16)
    return pools, host, q, rk, rv, jnp.asarray(rlen, jnp.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_attention_kernel_outputs_match_pallas(name):
    """The wrapper's plain version vs the Pallas megakernel on the same
    unified operands: out, m, l, mass and base."""
    pools, host, q, rk, rv, rlen = _case(name)
    (k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, slot, tier, t, _) = jops._unified_operands(
        q, pools, rk, host)
    want = j_fused(q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv, slot, tier, rlen,
                   page_tokens=t)
    got = pa.fused_tiered_attention(*(_t(a) for a in (
        q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv, slot, tier, rlen)), t)
    for field, g, w in zip(("out", "m", "l", "mass", "base"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=field, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiered_decode_attention_hotness_matches_reference(name):
    """ops-level: output and normalized per-page hotness (pools and host)
    vs ``repro.kernels.ops.tiered_decode_attention`` (fused path)."""
    pools, host, q, rk, rv, rlen = _case(name)
    j_out, j_hot = jops.tiered_decode_attention(q, pools, rk, rv, rlen, with_telemetry=True,
                                                host=host)
    t_out, t_hot = ops.tiered_decode_attention(
        _t(q), _to_port(pools), _t(rk), _t(rv), _t(rlen), with_telemetry=True,
        host=None if host is None else _to_port(host))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    assert set(t_hot) == set(j_hot)
    for k in j_hot:
        np.testing.assert_allclose(t_hot[k].numpy(), np.asarray(j_hot[k]), err_msg=k, **TOL)
    # The per-pool oracle (``ref.fused_tiered_attention``) gives the same hotness.
    port_pools, port_host = _to_port(pools), None if host is None else _to_port(host)
    o, m, lsum, masses = ref.fused_tiered_attention(_t(q), port_pools, _t(rk), _t(rv), _t(rlen),
                                                 host=port_host)
    np.testing.assert_allclose(o.numpy(), t_out.numpy(), **TOL)
    for k, (ms, bs) in masses.items():
        np.testing.assert_allclose(ops.page_hotness(ms, bs, m, lsum).numpy(), t_hot[k].numpy(),
                                   err_msg=k, **TOL)


def test_validated_page_tokens_raises_on_mixed_sizes():
    rng = np.random.default_rng(0)
    a = _to_port(_mk_pool(rng, 3, 8, 2, (1, 1)))
    b = dict(a, k_pages=torch.zeros((3, T * 2, KV, HD), dtype=torch.int8))
    with pytest.raises(ValueError, match="mixed page_tokens"):
        ops._validated_page_tokens({"a": a, "b": b}, None)
    host = dict(_to_port(_mk_host(rng)), page_tokens=T + 1)
    with pytest.raises(ValueError, match="host sentinels"):
        ops._validated_page_tokens({"a": a}, host)
    assert ops._validated_page_tokens({"a": a}, dict(host, page_tokens=T)) == T
    assert ops._validated_page_tokens({}, None) == 1


def test_check_class_bounds_raises_index_error():
    slot = torch.tensor([[0, 5, 2]], dtype=torch.int32)
    tier = torch.tensor([[pa.TIER_INT8, pa.TIER_INT8, pa.TIER_INVALID]], dtype=torch.int32)
    with pytest.raises(IndexError, match="int8 class row"):
        ops._check_class_bounds(slot, tier, rows8=5, rows4=1)
    ops._check_class_bounds(slot, tier, rows8=6, rows4=1)  # stale rows are exempt
    tier4 = torch.tensor([[pa.TIER_INVALID, pa.TIER_INT4, pa.TIER_INVALID]], dtype=torch.int32)
    with pytest.raises(IndexError, match="int4 class row"):
        ops._check_class_bounds(slot, tier4, rows8=1, rows4=3)


def test_class_operands_alias_by_identity():
    rng = np.random.default_rng(1)
    shared = _to_port(_mk_pool(rng, 6, 8, 3, (1, 2)))
    other = dict(shared, page_table=shared["page_table"].clone())  # same buffers
    ops.reset_copy_bytes()
    (k, *_), offs = ops._class_operands([shared, other], T, KV, torch.int8, HD, "cpu")
    assert k is shared["k_pages"] and offs == [0, 0] and ops.concat_copy_bytes() == 0
    # Equal values in separate buffers are NOT aliases: they concatenate.
    copy = {k_: (v.clone() if isinstance(v, torch.Tensor) else v) for k_, v in shared.items()}
    ops._class_operands([shared, copy], T, KV, torch.int8, HD, "cpu")
    assert ops.concat_copy_bytes() > 0
    mixed = dict(copy, k_pages=shared["k_pages"])
    with pytest.raises(ValueError, match="mix shared and standalone"):
        ops._class_operands([shared, mixed, copy], T, KV, torch.int8, HD, "cpu")
    ops.reset_copy_bytes()


def _per_pool_vs_fused(pools, host, q, rk, rv, rlen):
    """The port's per-pool path against its fused path and against the
    reference's per-pool path, outputs and hotness at 2e-4."""
    args = (_t(q), _to_port(pools), _t(rk), _t(rv), _t(rlen))
    port_host = None if host is None else _to_port(host)
    ops.use_fused(True)
    f_out, f_hot = ops.tiered_decode_attention(*args, with_telemetry=True, host=port_host)
    ops.use_fused(False)
    p_out, p_hot = ops.tiered_decode_attention(*args, with_telemetry=True, host=port_host)
    jops.use_fused(False)
    j_out, j_hot = jops.tiered_decode_attention(q, pools, rk, rv, rlen, with_telemetry=True,
                                                host=host)
    assert set(p_hot) == set(f_hot) == set(j_hot)
    for want_out, want_hot in ((f_out, f_hot), (j_out, j_hot)):
        np.testing.assert_allclose(p_out.numpy(), _n(want_out), **TOL)
        for k in p_hot:
            np.testing.assert_allclose(p_hot[k].numpy(), _n(want_hot[k]), err_msg=k, **TOL)
    return p_hot


@pytest.mark.parametrize("n_tiers", [2, 3, 4])
def test_per_pool_path_matches_fused(n_tiers):
    """tests/test_fused_attention.py's mixed-codec case on the port."""
    rng = np.random.default_rng(7)
    bits_seq = (8, 4, 8, 4)
    pools = {f"t{i}": _mk_pool(rng, 6, bits_seq[i], 4, rng.integers(1, 5, B))
             for i in range(n_tiers)}
    host = _mk_host(rng)
    q = jnp.asarray(rng.normal(0, 1, (B, H, HD)), jnp.float32)
    rk = jnp.asarray(rng.normal(0, 1, (B, R, KV, HD)), jnp.bfloat16)
    rv = jnp.asarray(rng.normal(0, 1, (B, R, KV, HD)), jnp.bfloat16)
    _per_pool_vs_fused(pools, host, q, rk, rv, jnp.asarray([R, R // 2], jnp.int32))
    ops.use_fused(False)
    assert ops.decode_launches_per_step(n_pools=n_tiers) == n_tiers
    ops.use_fused(True)
    assert ops.decode_launches_per_step(n_pools=n_tiers) == 1


@pytest.mark.parametrize("name", ["empty_pools", "all_host", "recent_len_zero"])
def test_per_pool_path_edges_match_fused(name):
    """An empty pool contributes zero hotness (m = 0 per pool), all-host
    and empty-recent-window sequences merge like the fused kernel."""
    hot = _per_pool_vs_fused(*_case(name))
    if name == "empty_pools":
        assert all(float(hot[k].abs().sum()) == 0.0 for k in hot if k != "host")
        assert float(hot["host"].sum()) > 0.0


def test_per_pool_engine_bills_launches_per_pool():
    """Under ``use_fused(False)`` the engine bills the reference's per-pool
    launch structure, layers x pools per decode step (``attn_launches``);
    the fused default bills one launch per layer."""
    from repro_torch.configs import TierScapeRunConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    from repro_torch.serving.engine import TieredEngine

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    prompt = np.random.default_rng(9).integers(1, cfg.vocab_size, 30)
    for fused, per_step in ((False, 2 * 2), (True, 2)):
        ops.use_fused(fused)
        jops.use_fused(fused)
        assert ops.decode_launches_per_step(n_pools=2) == jops.decode_launches_per_step(n_pools=2)
        eng = TieredEngine(model, params, batch_slots=2, page_tokens=8, max_seq_len=64,
                           recent_window=16, device="cpu",
                           ts=TierScapeRunConfig(enabled=True, window_steps=4))
        eng.submit(prompt, max_new_tokens=6)
        stats = eng.run(max_steps=20)
        assert stats.steps > 0 and stats.attn_launches == per_step * stats.steps


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    build.reset_launch_counts()
    rng = np.random.default_rng(3)
    pages = torch.from_numpy(rng.normal(0, 1, (2, T, KV, HD)).astype(np.float32))
    p, s = quant_page.quant_pages(pages, 8)
    transcode_page.transcode_pages(p, s, 8, 4)
    dequant_page.dequant_pages(p, s, 8, torch.float32)
    pools, host, q, rk, rv, rlen = _case("mixed")
    for fused in (True, False):
        ops.use_fused(fused)
        ops.tiered_decode_attention(_t(q), _to_port(pools), _t(rk), _t(rv), _t(rlen),
                                    host=_to_port(host))
    assert build.launch_counts() == {k: 0 for k in build.LAUNCHES}
