"""The split attention kernels' cut and merge, on the CPU.

``csrc/attn_split.cuh`` splits each sequence's work over the ranks of a
thread-block cluster: the valid rows of the unified table in table order,
then the recent window in chunks of ``T // 2`` tokens, rank r taking the
contiguous share [r W / S, (r + 1) W / S), and merges the ranks' (acc, m,
l) in rank order. Here each sequence's table is cut by that rule
(``split_shares``), every share runs the plain per-pool oracles row by
row, the items of a rank and then the ranks merge by the kernels' rule
(``ref.merge_ranks``), and the result is held to the JAX oracle
``repro.kernels.ref.fused_tiered_attention`` at rtol = atol = 2e-4 (out,
l and every row's mass and base), for clusters of 1, 3 and 8 ranks: ranks
with no row, a sequence with host sentinels only, empty recent windows and
grouped heads included. The oracle's m is the max over every partial, an
empty pool's m = 0 included, where the kernels' is the max over the
partials with mass (as the Pallas megakernel's running max); (m, l) is the
same logsumexp either way, so l is compared rescaled to the oracle's m. The
kernels themselves run only on a GPU (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
B, T, R, HD = 2, 8, 6, 32

CASES = {
    # name: (pool specs [(bits, n_valid per seq)], host n per seq or None, recent_len, kv, h)
    "mixed": ([(8, (9, 4)), (4, (6, 10))], (5, 2), (R, 3), 2, 8),
    "empty_stripes": ([(8, (1, 0)), (4, (0, 1))], None, (0, 0), 2, 8),
    "all_host": ([(8, (0, 0)), (4, (0, 0))], (6, 3), (0, R), 2, 8),
    "recent_len_zero": ([(8, (7, 2)), (4, (3, 11))], (4, 4), (0, 0), 2, 8),
    "gqa": ([(8, (5, 8)), (4, (9, 3))], (2, 6), (R, 5), 8, 64),
}


def _t(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x))


def _case(name):
    rng = np.random.default_rng(11)
    specs, host_n, rlen, kv, h = CASES[name]
    mp, pages = 12, 16
    pools = {}
    for i, (bits, n_valid) in enumerate(specs):
        x = jnp.asarray(rng.normal(0, 1, (pages, T, kv, HD)), jnp.bfloat16)
        kp, ks = jref.quant_kv_page(x, bits)
        vp, vs = jref.quant_kv_page(x * 0.5, bits)
        pools[f"t{i}"] = dict(
            k_pages=kp, k_scales=ks, v_pages=vp, v_scales=vs,
            page_table=jnp.asarray(rng.integers(0, pages, (B, mp)), jnp.int32),
            n_pages=jnp.asarray(n_valid, jnp.int32), bits=bits)
    host = None if host_n is None else dict(
        summary=jnp.asarray(rng.normal(0, 1, (9, kv, HD)), jnp.float32),
        table=jnp.asarray(rng.integers(0, 9, (B, 6)), jnp.int32),
        n=jnp.asarray(host_n, jnp.int32), page_tokens=T)
    q = jnp.asarray(rng.normal(0, 1, (B, h, HD)), jnp.float32)
    rk = jnp.asarray(rng.normal(0, 1, (B, R, kv, HD)), jnp.bfloat16)
    rv = jnp.asarray(rng.normal(0, 1, (B, R, kv, HD)), jnp.bfloat16)
    return pools, host, q, rk, rv, jnp.asarray(rlen, jnp.int32)


def split_shares(tiers: torch.Tensor, recent_len: int, page_tokens: int, n_ranks: int):
    """The kernels' cut of one sequence's work over ``n_ranks`` ranks: the
    rows of ``tiers`` [MS] with a tier code 0, 1 or 2 (int8, int4, host) in
    table order, as ("row", column), then the recent window in chunks of
    max(1, page_tokens // 2) tokens, as ("recent", first token, end token);
    rank r takes items [r W // S, (r + 1) W // S). One item list per rank."""
    items = [("row", int(c)) for c in torch.nonzero((tiers >= 0) & (tiers <= 2)).flatten()]
    rt = max(1, page_tokens // 2)
    items += [("recent", t0, min(t0 + rt, recent_len)) for t0 in range(0, recent_len, rt)]
    w = len(items)
    return [items[r * w // n_ranks:(r + 1) * w // n_ranks] for r in range(n_ranks)]


def _port(tree):
    return {k: (v if k in ("bits", "page_tokens") else _t(v)) for k, v in tree.items()}


def _split_attention(q, pools, host, rk, rv, rlen, n_ranks):
    """The kernels' function, computed share by share: returns out, m, l
    [B, H(, hd)] and the unified table's mass, base [B, MS]."""
    (k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, slot, tier, t, layout) = ops._unified_operands(
        q, pools, rk, host)
    b, h, hd = q.shape
    ms = slot.shape[1]
    one = torch.ones(1, dtype=torch.int32)
    out = torch.zeros((b, h, hd))
    m_out, l_out = torch.zeros((b, h)), torch.zeros((b, h))
    mass, base = torch.zeros((b, ms)), torch.full((b, ms), pa.NEG_INF)
    for i in range(b):
        qi = q[i:i + 1]
        ranks = []
        for share in split_shares(tier[i], int(rlen[i]), t, n_ranks):
            items = []
            for item in share:
                if item[0] == "recent":
                    t0, t1 = item[1:]
                    items.append(ref.dense_recent_attention(
                        qi, rk[i:i + 1, t0:t1], rv[i:i + 1, t0:t1], t1 - t0))
                    continue
                col = item[1]
                code, row = int(tier[i, col]), slot[i, col].reshape(1, 1)
                if code == pa.TIER_HOST:
                    pm, pb = ref.host_page_mass(qi, summary, row, one, t)
                else:
                    bits = 8 if code == pa.TIER_INT8 else 4
                    pool = (k8, s8k, v8, s8v) if bits == 8 else (k4, s4k, v4, s4v)
                    acc, m, lsum, pm, pb = ref.paged_quant_attention(qi, *pool, row, one, bits)
                    items.append((acc, m, lsum))
                mass[i, col], base[i, col] = pm[0, 0], pb[0, 0]
            if not items:  # a rank without work: l = 0, never weighed in
                items = [(torch.zeros((1, h, hd)), torch.full((1, h), pa.NEG_INF),
                          torch.zeros((1, h)))]
            ranks.append(ref.merge_ranks(items))
        acc, m, lsum = ref.merge_ranks(ranks)
        out[i] = (acc / torch.clamp(lsum, min=1e-30)[..., None])[0]
        m_out[i], l_out[i] = m[0], lsum[0]
    return out, m_out, l_out, mass, base, layout


@pytest.mark.parametrize("n_ranks", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_matches_reference(name, n_ranks):
    pools, host, q, rk, rv, rlen = _case(name)
    j_out, j_m, j_l, j_masses = jref.fused_tiered_attention(q, pools, rk, rv, rlen, host=host)
    out, m, lsum, mass, base, layout = _split_attention(
        _t(q), {k: _port(p) for k, p in pools.items()}, None if host is None else _port(host),
        _t(rk), _t(rv), _t(rlen), n_ranks)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), err_msg="out", **TOL)
    l_at_ref = lsum * torch.exp(m - _t(j_m))
    np.testing.assert_allclose(l_at_ref.numpy(), np.asarray(j_l), err_msg="l", **TOL)
    assert bool((m[lsum == 0] == 0).all())
    for k, (jm, jb) in j_masses.items():
        lo, hi = layout[k]
        np.testing.assert_allclose(mass[:, lo:hi].numpy(), np.asarray(jm), err_msg=k, **TOL)
        np.testing.assert_allclose(base[:, lo:hi].numpy(), np.asarray(jb), err_msg=k, **TOL)
    # The plain version the CPU wrapper runs merges by the same rule.
    operands = ops._unified_operands(_t(q), {k: _port(p) for k, p in pools.items()}, _t(rk),
                                     None if host is None else _port(host))
    plain = pa.fused_tiered_attention(_t(q), *operands[:9], _t(rk), _t(rv), *operands[9:11],
                                      _t(rlen), operands[11])
    for field, g, w in zip(("out", "m", "l"), plain, (out, m, lsum)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=field, **TOL)


def test_split_shares_cover_the_work_once():
    """Every valid row and every recent token lands in exactly one share,
    in table order, and the shares differ in size by at most one item."""
    tier = torch.tensor([0, -1, 2, 1, 1, -1, 0, 2, -1, 1], dtype=torch.int32)
    for n_ranks in (1, 3, 8, 16):
        shares = split_shares(tier, 13, 8, n_ranks)
        flat = [it for s in shares for it in s]
        assert [it[1] for it in flat if it[0] == "row"] == [0, 2, 3, 4, 6, 7, 9]
        assert [it[1:] for it in flat if it[0] == "recent"] == [(0, 4), (4, 8), (8, 12), (12, 13)]
        sizes = [len(s) for s in shares]
        assert len(shares) == n_ranks and max(sizes) - min(sizes) <= 1
