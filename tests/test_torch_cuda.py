"""The CUDA kernels against their plain versions, on a GPU.

Torch-only (the GPU host has no JAX): quant and transcode byte-equal, fused
attention within rtol = atol = 2e-4, across the reference sweep of page
shapes and head groupings (GQA included), mixed int8/int4/host/invalid
table rows and an empty recent window. Every test skips where
``torch.cuda.is_available()`` is False; on the GPU host run

    python -m pytest -q tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quant_page, transcode_page  # noqa: E402

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


def test_wrappers_reject_bad_operands(gen):
    x = torch.randn((2, 8, 2, 32), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        quant_page.quant_pages(x.to(torch.float16), 8)
    with pytest.raises(ValueError):
        quant_page.quant_pages(x.transpose(1, 2), 8)
    p, s = quant_page.quant_pages(x, 8)
    with pytest.raises(ValueError):
        transcode_page.transcode_pages(p, s.cpu(), 8, 4)


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
