"""The port's cxl_hw tier against the JAX package, on the CPU: the page codec
kernels' plain versions (``cxl_encode_pages`` / ``cxl_decode_pages``), the
codec transforms of ``core/codecs.py``, and the cache reading HOST8 pages
that live on the ``cxl_hw`` expander.

Bars are ``tests/test_cxl.py``'s: payloads and line widths byte-equal,
scales within rtol 1e-6, decode within rtol 1e-6 (here bit-equal). The
encode's payload and scales are also byte-equal to the port's
``quant_pages(., 8)``, and the decode bit-equal to ``dequant_pages(., 8,
f32)``: the expander's codec is the int8 codec plus line widths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.kernels import cxl_line as jcxl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import codecs  # noqa: E402
from repro_torch.kernels import cxl_line, dequant_page, ops, quant_page, ref  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402

LINE = ref.CXL_LINE_ELEMS


def _pages(hd: int, seed: int = 1) -> np.ndarray:
    """Pages whose lines narrow in known places: page 0's later lines are
    tiny against the row amax (codewords in int4 range), page 1's later lines
    are all zero (a pad tail), page 2 is plain gaussian."""
    rng = np.random.default_rng(seed)
    pages = rng.normal(0, 1, (3, 4, 2, hd)).astype(np.float32)
    pages[0, :, :, LINE:] *= 1e-3
    pages[1, :, :, LINE:] = 0.0
    return pages


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cxl_encode_matches_reference(hd, dtype):
    pages = _pages(hd)
    jx = jnp.asarray(pages, getattr(jnp, dtype))
    tx = tensor_from_numpy(np.asarray(jx))
    payload, scales, bits = ops.cxl_encode_pages(tx)
    assert payload.dtype == torch.int8 and scales.dtype == torch.float32
    assert bits.dtype == torch.int32 and bits.shape == (3, 4, 2, hd // LINE)
    for jp_, js_, jb_ in (jcxl.cxl_encode_pages(jx, interpret=True), jref.cxl_encode_kv_page(jx)):
        np.testing.assert_array_equal(payload.numpy(), np.asarray(jp_))
        np.testing.assert_allclose(scales.numpy(), np.asarray(js_), rtol=1e-6)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jb_))
    # The expander's codec is the int8 codec plus line widths.
    qp, qs = quant_page.quant_pages(tx, 8)
    assert torch.equal(payload, qp) and torch.equal(scales, qs)
    assert torch.equal(bits, ref.cxl_page_line_bits(payload))
    b = bits.numpy()
    assert (b[:, ..., 0] == 8).all()  # the line holding each row's amax stays wide
    if hd > LINE:
        assert (b[0, ..., 1:] == 4).all() and (b[1, ..., 1:] == 4).all()
    assert ref.cxl_page_line_ratio(bits) == jref.cxl_page_line_ratio(np.asarray(jb_))
    assert ref.cxl_page_line_ratio(bits) > 1.0 if hd > LINE else set(np.unique(b)) == {8}


@pytest.mark.parametrize("shape", [(3, 4, 2, 64), (2, 16, 4, 16), (1, 8, 3, 128)])
def test_cxl_decode_matches_reference(shape):
    """Decode has no line-geometry limit (hd 16 is the zamba2 SMOKE's)."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, shape).astype(np.float32)
    jp_, js_ = jref.quant_kv_page(jnp.asarray(x), 8)
    payload, scales = tensor_from_numpy(np.asarray(jp_)), tensor_from_numpy(np.asarray(js_))
    got = cxl_line.cxl_decode_pages(payload, scales)
    assert got.dtype == torch.float32 and got.shape == shape
    for want in (jcxl.cxl_decode_pages(jp_, js_, interpret=True), jref.cxl_decode_kv_page(jp_, js_)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, dequant_page.dequant_pages(payload, scales, 8, torch.float32))
    assert torch.equal(got, ref.cxl_decode_kv_page(payload, scales))


def test_cxl_encode_rejects_line_geometry():
    with pytest.raises(ValueError, match="multiple"):
        ops.cxl_encode_pages(torch.zeros((1, 2, 2, 16)))  # the zamba2 SMOKE head_dim


# ---------------------------------------------------------------------------
# core/codecs.py: the software side of the tiers
# ---------------------------------------------------------------------------


def _block(seed: int, small: bool = False) -> np.ndarray:
    x = np.random.default_rng(seed).normal(0, 1, 4 * 512).astype(np.float32)
    if small:  # lines narrow: tiny values with each scale group's amax pinned
        x = x * 1e-3
        x[::512] = 1.0
    return x


@pytest.mark.parametrize("name", sorted(jcodecs.CODECS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_codec_encode_decode_match_reference(name, dtype):
    x = _block(3)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = tensor_from_numpy(np.asarray(jx))
    jc, tc = jcodecs.CODECS[name], codecs.CODECS[name]
    assert (tc.name, tc.bits_per_elem, tc.group) == (jc.name, jc.bits_per_elem, jc.group)
    jenc, tenc = jc.encode(jx), tc.encode(tx)
    assert tenc.codec == jenc.codec
    assert tenc.payload.dtype == torch.uint8
    np.testing.assert_array_equal(tenc.payload.numpy(), np.asarray(jenc.payload))
    np.testing.assert_allclose(tenc.scales.numpy(), np.asarray(jenc.scales), rtol=1e-6)
    for out in ("float32", "bfloat16"):
        jd = jc.decode(jenc, (4, 512), getattr(jnp, out))
        td = tc.decode(tenc, (4, 512), getattr(torch, out))
        assert td.shape == (4, 512) and td.dtype == getattr(torch, out)
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jnp.asarray(jd, jnp.float32)))
    assert float(codecs.roundtrip_error(name, tx)) == pytest.approx(
        float(jcodecs.roundtrip_error(name, jx)), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("small", [False, True])
def test_cxl_line_accounting_matches_reference(small):
    x = _block(4, small)
    jenc = jcodecs.CODECS["cxl_hw"].encode(jnp.asarray(x, jnp.bfloat16))
    tenc = codecs.CODECS["cxl_hw"].encode(tensor_from_numpy(np.asarray(jnp.asarray(
        x, jnp.bfloat16))))
    np.testing.assert_array_equal(codecs.cxl_line_bits(tenc.payload).numpy(),
                                  np.asarray(jcodecs.cxl_line_bits(jenc.payload)))
    assert codecs.cxl_wire_bytes(tenc.payload, tenc.scales) == jcodecs.cxl_wire_bytes(
        jenc.payload, jenc.scales)
    ratio = codecs.cxl_line_ratio(tenc.payload)
    assert ratio == jcodecs.cxl_line_ratio(jenc.payload)
    assert ratio > 1.5 if small else ratio == pytest.approx(1.0, abs=0.05)
    # numpy bytes (the cache's host payloads) count the same as tensors.
    np.testing.assert_array_equal(codecs.cxl_line_bits(tenc.payload.numpy()).numpy(),
                                  codecs.cxl_line_bits(tenc.payload).numpy())


# ---------------------------------------------------------------------------
# The cache reads HOST8 pages on the cxl_hw expander through cxl_decode_pages
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)


def _caches(host_media_device):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.core.manager import ManagerConfig as JManagerConfig
    from repro.serving.kv_cache import TieredKVCache as JCache
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.serving.kv_cache import TieredKVCache

    j = JCache(JModelConfig(**TINY), 2, 2, 8, 64, 16, JManagerConfig(policy="analytical"),
               host_media_device=host_media_device)
    t = TieredKVCache(ModelConfig(**TINY), 2, 2, 8, 64, 16, ManagerConfig(policy="analytical"),
                      host_media_device=host_media_device, device="cpu")
    return j, t


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("host_media_device", ["cxl_hw", ""])
def test_cache_reads_host8_on_cxl_hw_through_cxl_decode(monkeypatch, host_media_device):
    """Pages demoted to HOST8 get their sentinel centroid, and pages fetched
    back from HOST8 by the per-page path get their values, through
    ``cxl_decode_pages`` when the host tiers live on ``cxl_hw`` (else through
    ``dequant_pages``): centroids, placements, payloads and the
    kernel-dispatch bill equal the reference's either way."""
    j, t = _caches(host_media_device)
    spies = {n: _Spy(getattr(ops, n)) for n in ("cxl_decode_pages", "dequant_pages")}
    for n, spy in spies.items():
        monkeypatch.setattr(ops, n, spy)
    rng = np.random.default_rng(6)
    coords = [(la, sl, pg) for la in range(2) for sl in range(2) for pg in range(6)]
    k = rng.normal(0, 1, (len(coords), 8, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (len(coords), 8, 2, 16)).astype(np.float32)
    j.append_pages(coords, jnp.asarray(k), jnp.asarray(v))
    t.append_pages(coords, torch.from_numpy(k), torch.from_numpy(v))
    live = np.where(t._page_exists)[0]
    host8 = live[::2]
    for c in (j, t):
        c.migrate_batch(host8, np.full(host8.size, 3, np.int64))  # to HOST8
    on_cxl = spies["cxl_decode_pages"].calls  # one per sentinel batch
    assert on_cxl > 0 if host_media_device else on_cxl == 0
    for r in host8[:4]:  # per-page fetches back to the device pools
        j.migrate(int(r), 2)
        t.migrate(int(r), 2)
    assert spies["cxl_decode_pages"].calls == on_cxl + (8 if host_media_device else 0)
    np.testing.assert_array_equal(t.physical, j.physical)
    assert int((t.physical == 3).sum()) == host8.size - 4
    rids = np.array(sorted(t.host_pages), np.int64)
    assert set(t.host_pages) == set(j.host_pages)
    for r in rids:
        t_page, j_page = t.host_pages[int(r)], j.host_pages[int(r)]
        for i in (0, 2):  # payloads byte-equal
            np.testing.assert_array_equal(np.asarray(t_page[i]), np.asarray(j_page[i]))
        for i in (1, 3):  # scales: the reference's jitted quant differs by 1 ulp
            np.testing.assert_allclose(np.asarray(t_page[i]), np.asarray(j_page[i]), rtol=1e-6)
    layers = rids // (t.bs * t.max_pages)
    np.testing.assert_allclose(
        t.state.host_summary[layers, t._host_slot[rids]].numpy(),
        np.asarray(j.state.host_summary)[layers, j._host_slot[rids]], rtol=1e-6, atol=1e-6)
    for f in ("cold_n", "host_n", "warm_n"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(),
                                      np.asarray(getattr(j.state, f)))
    assert t.kernel_dispatches == j.kernel_dispatches


def test_cxl_decode_leaves_values_and_placements_unchanged():
    """The port's cache with its host tiers on ``cxl_hw`` (HOST8 reads
    through ``cxl_decode_pages``) and on the default host DRAM (every read
    through ``dequant_pages``): the same placements, byte-equal host pages,
    bit-equal sentinel centroids and the same dispatch bill."""
    caches = [_caches(d)[1] for d in ("cxl_hw", "")]
    rng = np.random.default_rng(8)
    coords = [(la, sl, pg) for la in range(2) for sl in range(2) for pg in range(6)]
    k = torch.from_numpy(rng.normal(0, 1, (len(coords), 8, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (len(coords), 8, 2, 16)).astype(np.float32))
    for c in caches:
        c.append_pages(coords, k, v)
        live = np.where(c._page_exists)[0]
        c.migrate_batch(live[::2], np.full(live[::2].size, 3, np.int64))
        c.migrate_batch(live[1::4], np.full(live[1::4].size, 4, np.int64))
        for r in live[:8:2]:
            c.migrate(int(r), 2)
    a, b = caches
    np.testing.assert_array_equal(a.physical, b.physical)
    assert int((a.physical == 3).sum()) > 0 and int((a.physical == 4).sum()) > 0
    assert set(a.host_pages) == set(b.host_pages)
    for r in a.host_pages:
        for x, y in zip(a.host_pages[r], b.host_pages[r]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for f in ("host_summary", "host_table", "host_n", "c8_k", "c8_k_scales", "c4_v"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert a.kernel_dispatches == b.kernel_dispatches


def test_hybrid_engine_host8_cohort_on_cxl_hw_matches_reference(monkeypatch):
    """Both engines serve the zamba2 SMOKE config on the default async +
    prefetch path with their host tiers on ``cxl_hw``. The analytical policy
    leaves HOST8 empty at this size, so after the first window both get the
    same blocking HOST8 cohort (as ``chip_smoke.py`` drives one) and then
    serve on. Tokens and placements after every step, the sentinel centroids
    of the cohort, the stats and the kernel-dispatch bill equal the
    reference's; the port read the expander's pages through
    ``cxl_decode_pages``."""
    import jax

    from repro.configs import TierScapeRunConfig as JRunConfig
    from repro.configs import get_smoke
    from repro.models import Model as JModel
    from repro.serving.engine import TieredEngine as JEngine
    from repro_torch.configs import TierScapeRunConfig
    from repro_torch.configs import get_smoke as port_smoke
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.engine import TieredEngine

    cfg = get_smoke("zamba2_1_2b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_smoke("zamba2_1_2b"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    run = dict(enabled=True, policy="analytical", alpha=0.05, window_steps=6,
               async_migration=True, prefetch=True, faults=False, host_media_device="cxl_hw")
    engine = dict(batch_slots=2, page_tokens=8, max_seq_len=128, recent_window=16)
    je = JEngine(jm, jp, ts=JRunConfig(**run), **engine)
    te = TieredEngine(tm, tp, ts=TierScapeRunConfig(**run), device="cpu", **engine)
    spy = _Spy(ops.cxl_decode_pages)
    monkeypatch.setattr(ops, "cxl_decode_pages", spy)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (40, 33)]
    jreqs = [je.submit(p, max_new_tokens=14) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=14) for p in prompts]
    cohort = None
    while any(s is not None for s in je.slots) or je.queue:
        assert je.stats.steps < 40
        je._fill_slots()
        te._fill_slots()
        if cohort is None and je.stats.windows == 1:
            je.cache.drain_migrations()
            te.cache.drain_migrations()
            assert not (te.cache.physical == kvc.HOST8).any()
            dev = np.where(np.isin(te.cache.physical, (kvc.WARM, kvc.COLD))
                           & te.cache._page_exists)[0]
            cohort = dev[:: max(dev.size // 6, 1)][:6]
            dst = np.full(cohort.size, kvc.HOST8, np.int64)
            assert je.cache.migrate_batch(cohort, dst) == te.cache.migrate_batch(cohort, dst) > 0
            assert (te.cache.physical[cohort] == kvc.HOST8).all()
            assert spy.calls > 0
            # Each centroid is the mean over tokens of the expander's K page
            # read back (bit-equal to the plain int8 dequant). The two
            # packages' K/V pages differ by bf16 roundings upstream (ROADMAP
            # section 3), so the reference's centroids are held to the K/V
            # cache bar of test_torch_hybrid.py.
            t, j = te.cache, je.cache
            layers = cohort // (t.bs * t.max_pages)
            got = t.state.host_summary[layers, t._host_slot[cohort]].numpy()
            pay, sc = (np.stack([t.host_pages[int(r)][i] for r in cohort]) for i in (0, 1))
            want = ref.dequant_kv_page(torch.from_numpy(pay), torch.from_numpy(sc), 8)
            np.testing.assert_array_equal(got, want.numpy().mean(axis=1))
            np.testing.assert_allclose(
                got, np.asarray(j.state.host_summary)[layers, j._host_slot[cohort]],
                atol=0.125, rtol=2.0**-5)
        je.step()
        te.step()
        np.testing.assert_array_equal(te.cache.physical, je.cache.physical)
        np.testing.assert_array_equal(te.cache.manager.placement, je.cache.manager.placement)
    assert cohort is not None
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 14 and r.done for r in treqs)
    js, ts = je.finish(), te.finish()
    for f in ("steps", "windows", "migrations", "completed", "overlapped_steps",
              "prefetch_staged", "prefetch_hits", "prefetch_misses", "attn_launches"):
        assert getattr(ts, f) == getattr(js, f), f
    assert te.cache.kernel_dispatches == je.cache.kernel_dispatches
