"""reindexer_tpu_torch ops vs the JAX package's ops, on the same seeded
numpy inputs.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Tolerance: rtol 1e-4, atol 1e-3 on scores (tests/test_pallas_select.py's),
ids compared as sets per query. Tests marked `cuda` hold each CUDA kernel
against its plain version on the card and skip without one; they import no
JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ops.py
"""
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from reindexer_tpu_torch import VectorMetric
from reindexer_tpu_torch.ops import _build, distance, scan, select
from reindexer_tpu_torch.ops.scan import SQ_EFF_BIG, bf_scan, bf_scan_plain
from reindexer_tpu_torch.ops.select import (S_SLOTS, bf_select,
                                            bf_select_plain, knn_scan_fused)

# this file runs beside timing-sensitive tests (the TCP cluster's raft
# timeouts) when the suite is spread over processes: a small intra-op pool
# keeps torch from taking every core
torch.set_num_threads(2)

N, D = 2 * 8192, 128
RTOL, ATOL = 1e-4, 1e-3
METRICS = [VectorMetric.L2, VectorMetric.INNER_PRODUCT]
INVALID = [5, 777, 9001]


def _ref():
    """The JAX package's ops, imported here rather than at module level so
    that the `cuda` tests of this file run where JAX is absent."""
    import jax.numpy as jnp
    from reindexer_tpu.ops import distance as rdist
    from reindexer_tpu.ops import pallas_scan, pallas_select
    return jnp, rdist, pallas_scan, pallas_select


def _inputs(seed, n_q, metric, n=N, d=D):
    """q, base, sq_eff as numpy. Rows in INVALID are zeroed AND carry
    sq_eff = SQ_EFF_BIG, so the JAX kernels' zeroed-rows contract and the
    port's sq_eff contract both hold."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    invalid = [r for r in INVALID if r < n]
    base[invalid] = 0.0
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    sq = ((base * base).sum(1) if metric == VectorMetric.L2
          else np.zeros(n)).astype(np.float32)
    sq[invalid] = SQ_EFF_BIG
    return q, base, sq


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _assert_same_topk(s, i, s_ref, i_ref):
    s, i, s_ref, i_ref = map(np.asarray, (s, i, s_ref, i_ref))
    for b in range(i.shape[0]):
        assert set(i[b].tolist()) == set(i_ref[b].tolist()), b
    np.testing.assert_allclose(s, s_ref, rtol=RTOL, atol=ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda", 0)


# --- K1 / K2 plain versions vs the JAX package's Pallas kernels ------------

@pytest.mark.parametrize("metric", METRICS)
def test_bf_scan_plain_matches_pass1(metric):
    jnp, _, pallas_scan, _ = _ref()
    q, base, sq = _inputs(1, 8, metric)
    ps, bmax = pallas_scan._pass1(jnp.asarray(q), jnp.asarray(base),
                                  jnp.asarray(sq)[None, :], pallas_scan.TILE,
                                  metric, interpret=True)
    s, bm = bf_scan(*_t(q, base, sq), metric)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(bm.numpy(), np.asarray(bmax).T, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_bf_scan_plain_matches_pass1_ps(metric):
    """K1's S covers pallas_scan._pass1_ps (partial scores only, validity in
    sq_eff alone): invalid rows keep their data here, as in the port's
    keeper, and both sides score them at or below -5e29. The top-k of
    knn_scan_fused_single (its wrapper) equals K1 + K2's."""
    jnp, _, pallas_scan, _ = _ref()
    rng = np.random.default_rng(16)
    base = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(8, D)).astype(np.float32)
    sq = ((base * base).sum(1) if metric == VectorMetric.L2
          else np.zeros(N)).astype(np.float32)
    sq[INVALID] = SQ_EFF_BIG
    valid = sq < SQ_EFF_BIG / 2
    ps = np.asarray(pallas_scan._pass1_ps(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(sq)[None, :],
        pallas_scan.TILE, metric, interpret=True))
    s, _ = bf_scan_plain(*_t(q, base, sq), metric)
    s = s.numpy()
    np.testing.assert_allclose(s[:, valid], ps[:, valid], rtol=RTOL,
                               atol=ATOL)
    assert (s[:, ~valid] <= scan.SENT_HALF).all()
    assert (ps[:, ~valid] <= scan.SENT_HALF).all()
    k = 20
    s_r, i_r = pallas_scan.knn_scan_fused_single(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(sq), k, metric,
        interpret=True)
    s_p, i_p, flag = knn_scan_fused(*_t(q, base, sq), k, metric)
    assert float(flag.max()) == 0.0
    _assert_same_topk(s_p, i_p, s_r, i_r)
    assert not np.isin(i_p.numpy(), INVALID).any()


@pytest.mark.parametrize("metric", METRICS)
def test_knn_scan_fused_matches_v3(metric):
    jnp, _, _, pallas_select = _ref()
    q, base, sq = _inputs(2, 8, metric)
    k = 20
    s_r, i_r, f_r = pallas_select.knn_scan_fused_v3(
        jnp.asarray(q), jnp.asarray(base), k, metric, interpret=True)
    s, i, flag = knn_scan_fused(*_t(q, base, sq), k, metric)
    assert float(f_r) <= 0.0 and float(flag.max()) == 0.0
    _assert_same_topk(s, i, s_r, i_r)
    assert not np.isin(i.numpy(), INVALID).any()


@pytest.mark.parametrize("metric", METRICS)
def test_knn_scan_fused_matches_v4(metric):
    """A [R=3, 8, D] stack: the JAX pipelined kernel takes it in one
    launch; the port runs the flattened 24 queries through K1 + K2."""
    jnp, _, _, pallas_select = _ref()
    r, qb, k = 3, 8, 10
    q, base, sq = _inputs(3, r * qb, metric)
    s_r, i_r, f_r = pallas_select.knn_scan_fused_v4(
        jnp.asarray(q.reshape(r, qb, D)), jnp.asarray(base), k, metric,
        interpret=True)
    s, i, flag = knn_scan_fused(*_t(q, base, sq), k, metric)
    assert float(f_r) <= 0.0 and float(flag.max()) == 0.0
    _assert_same_topk(s.reshape(r, qb, k).flatten(0, 1),
                      i.reshape(r, qb, k).flatten(0, 1),
                      np.asarray(s_r).reshape(r * qb, k),
                      np.asarray(i_r).reshape(r * qb, k))


def test_fewer_valid_than_k():
    """Seven valid rows, k=64: threshold clamps to the valid blocks and the
    rest pads with -inf / -1 (tests/test_pallas_select.py:210)."""
    rng = np.random.default_rng(4)
    base = np.zeros((N, D), np.float32)
    base[:7] = rng.normal(size=(7, D))
    sq = np.full(N, SQ_EFF_BIG, np.float32)
    sq[:7] = (base[:7] ** 2).sum(1)
    q = rng.normal(size=(4, D)).astype(np.float32)
    s, i, flag = knn_scan_fused(*_t(q, base, sq), 64, VectorMetric.L2)
    assert float(flag.max()) == 0.0
    for b in range(4):
        assert sorted(i[b, :7].tolist()) == list(range(7))
        assert (i[b, 7:] == -1).all() and torch.isinf(s[b, 7:]).all()
    want = -((q[:, None, :] - base[None, :7]) ** 2).sum(-1)
    np.testing.assert_allclose(s[:, :7].numpy(), -np.sort(-want, axis=1),
                               rtol=RTOL, atol=ATOL)


def test_mass_ties_set_the_flag():
    """Identical vectors tie every block max: more than 128 blocks are
    admitted and the flag is raised (tests/test_pallas_select.py:161)."""
    rng = np.random.default_rng(5)
    base = np.tile(rng.normal(size=(1, D)).astype(np.float32), (N, 1))
    sq = (base * base).sum(1).astype(np.float32)
    q = rng.normal(size=(4, D)).astype(np.float32)
    _, _, flag = knn_scan_fused(*_t(q, base, sq), 32, VectorMetric.L2)
    assert (flag > 0).all()


def test_bf_select_plain_contract():
    """eps widens the threshold (more admitted blocks, same top-k until the
    slot capacity overflows); an invalid block is never admitted."""
    rng = np.random.default_rng(6)
    n_q, n, k = 3, 64 * 300, 16
    s = torch.from_numpy(rng.normal(size=(n_q, n)).astype(np.float32))
    s[:, :64] = -1e30                                # block 0 invalid
    bmax = s.view(n_q, -1, 64).amax(2)
    zero = torch.zeros(n_q)
    top_s, top_i, flag = bf_select_plain(s, bmax, zero, k)
    want_s, want_i = torch.topk(s, k, dim=1)
    assert (flag == 0).all()
    assert torch.equal(top_s, want_s)
    assert (top_i >= 64).all()
    wide_s, _, wide_flag = bf_select_plain(s, bmax, zero + 0.2, k)
    assert (wide_flag == 0).all() and torch.equal(wide_s, want_s)
    _, _, over = bf_select_plain(s, bmax, zero + 100.0, k)
    assert (over > 0).all()          # every valid block admitted: 299 > 128


def _first_bf_select_plain(s, bmax, eps, k):
    """The first K2's steps: tau, admit, then the k best of every row of the
    admitted blocks (no filter), ties by the smaller row."""
    n_q, n = s.shape
    valid = bmax > scan.SENT_HALF
    neg_inf = torch.tensor(float("-inf"))
    kth = torch.topk(torch.where(valid, bmax, neg_inf),
                     min(k, bmax.shape[1]), dim=1).values[:, -1]
    tau = torch.where(valid.sum(dim=1) >= k, kth - eps, neg_inf)
    admit = valid & (bmax >= tau[:, None])
    flag = (admit.sum(dim=1) > S_SLOTS).to(torch.float32)
    cand = torch.where(admit.repeat_interleave(64, dim=1), s, neg_inf)
    top_i = torch.sort(cand, dim=1, descending=True, stable=True).indices
    top_i = top_i[:, :k]
    return (*select._emit(torch.gather(cand, 1, top_i), top_i, k), flag)


@st.composite
def _select_case(draw):
    """Scores of few distinct values (mass ties at tau), invalid rows and
    whole invalid blocks, eps >= 0, k from 1 to 128, up to 200 blocks (more
    than 128 admitted overflows)."""
    n_q = draw(st.integers(1, 3))
    n_blocks = draw(st.integers(1, 200))
    k = draw(st.sampled_from([1, 2, 5, 64, 100, 127, 128]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    levels = draw(st.sampled_from([3, 10, 1000]))
    p_invalid_row = draw(st.sampled_from([0.0, 0.3, 0.97]))
    p_invalid_block = draw(st.sampled_from([0.0, 0.5, 1.0]))
    eps = draw(st.sampled_from([0.0, 0.5, 2.0]))
    rng = np.random.default_rng(seed)
    s = rng.integers(0, levels, (n_q, n_blocks * 64)).astype(np.float32)
    s[rng.random(s.shape) < p_invalid_row] = -1e30
    dead = rng.random((n_q, n_blocks)) < p_invalid_block
    s.reshape(n_q, n_blocks, 64)[dead] = -1e30
    s = torch.from_numpy(s)
    return s, s.view(n_q, -1, 64).amax(2), torch.full((n_q,), eps), k


@settings(max_examples=150, deadline=None)
@given(_select_case())
@example((torch.full((2, 64 * 150), 3.0), torch.full((2, 150), 3.0),
          torch.zeros(2), 32))                          # overflow: all tie
@example((torch.full((1, 640), -1e30), torch.full((1, 10), -1e30),
          torch.zeros(1), 128))                         # nothing valid
def test_bf_select_plain_filter_keeps_the_first_result(case):
    """K2's filter S >= tau before the top-k changes nothing: the plain
    version with the filter equals the first K2's steps exactly (scores,
    ids with ties by the smaller row, flag)."""
    s, bmax, eps, k = case
    got = bf_select_plain(s, bmax, eps, k)
    want = _first_bf_select_plain(s, bmax, eps, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bf_select_plain_orders_ties_by_row():
    """Tied scores come out smaller row first, as K2's keys order them."""
    s = torch.zeros((1, 64 * 4))
    s[0, [200, 3, 70, 130]] = 1.0
    top_s, top_i, _ = bf_select_plain(s, s.view(1, -1, 64).amax(2),
                                      torch.zeros(1), 6)
    assert top_i[0, :4].tolist() == [3, 70, 130, 200]
    assert top_i[0, 4:].tolist() == [0, 1]
    assert top_s[0].tolist() == [1.0] * 4 + [0.0] * 2


# --- the plain scans vs the JAX package's XLA scans ------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("chunk", [262144, 1024])
def test_knn_scan_matches_reference(metric, chunk):
    jnp, rdist, _, _ = _ref()
    rng = np.random.default_rng(7)
    n, k = 4096, 50
    base = rng.normal(size=(n, D)).astype(np.float32)
    valid = rng.random(n) > 0.1
    sq = (base * base).sum(1).astype(np.float32)
    q = rng.normal(size=(5, D)).astype(np.float32)
    s_r, i_r = rdist.knn_scan(jnp.asarray(q), jnp.asarray(base),
                              jnp.asarray(valid), jnp.asarray(sq), k, metric,
                              chunk=chunk)
    s, i = distance.knn_scan(*_t(q, base, valid, sq), k, metric, chunk=chunk)
    assert i.dtype == torch.int32
    _assert_same_topk(s, i, s_r, i_r)
    assert valid[i.numpy()].all()


def test_knn_scan_pads_when_k_exceeds_rows():
    rng = np.random.default_rng(8)
    base = rng.normal(size=(64, D)).astype(np.float32)
    q = rng.normal(size=(2, D)).astype(np.float32)
    valid = np.ones(64, bool)
    s, i = distance.knn_scan(*_t(q, base, valid, (base ** 2).sum(1)), 80,
                             VectorMetric.L2)
    assert (i[:, 64:] == -1).all() and torch.isinf(s[:, 64:]).all()
    assert sorted(i[0, :64].tolist()) == list(range(64))


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_scores_matches_reference(metric):
    jnp, rdist, _, _ = _ref()
    rng = np.random.default_rng(9)
    base = rng.normal(size=(512, D)).astype(np.float32)
    valid = rng.random(512) > 0.2
    sq = (base * base).sum(1).astype(np.float32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    want = np.asarray(rdist.pairwise_scores(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(valid),
        jnp.asarray(sq), metric))
    got = distance.pairwise_scores(*_t(q, base, valid, sq), metric).numpy()
    assert (np.isinf(got) == ~valid[None, :]).all()
    np.testing.assert_allclose(got[:, valid], want[:, valid], rtol=RTOL,
                               atol=ATOL)


def test_rank_helpers_match_reference():
    _, rdist, _, _ = _ref()
    x = np.random.default_rng(10).normal(size=(6, 16)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_array_equal(distance.normalize_rows(x),
                                  rdist.normalize_rows(x))
    for m in (VectorMetric.L2, VectorMetric.INNER_PRODUCT,
              VectorMetric.COSINE):
        assert distance.metric_ordering(m) == rdist.metric_ordering(m)
        np.testing.assert_array_equal(distance.scores_to_ranks(x[0], m),
                                      np.asarray(rdist.scores_to_ranks(x[0],
                                                                       m)))


# --- wrappers: device routing and launch counts ----------------------------

def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    q, base, sq = _t(*_inputs(11, 4, VectorMetric.L2, n=2048))
    scan.launches.reset()
    select.launches.reset()
    s, bmax = bf_scan(q, base, sq, VectorMetric.L2)
    s_p, bmax_p = bf_scan_plain(q, base, sq, VectorMetric.L2)
    assert torch.equal(s, s_p) and torch.equal(bmax, bmax_p)
    out = bf_select(s, bmax, torch.zeros(4), 10)
    ref = bf_select_plain(s, bmax, torch.zeros(4), 10)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert scan.launches.value == 0 and select.launches.value == 0


def test_wrappers_reject_other_devices_and_bad_shapes():
    meta = torch.empty((4, D), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bf_scan(meta, torch.empty((2048, D), device="meta"),
                torch.empty((2048,), device="meta"), VectorMetric.L2)
    q, base, sq = _t(*_inputs(12, 4, VectorMetric.L2, n=2048))
    with pytest.raises(ValueError, match="N % 64"):
        bf_scan(q, base[:2000], sq[:2000], VectorMetric.L2)
    with pytest.raises(ValueError, match="float32"):
        bf_scan(q.double(), base, sq, VectorMetric.L2)
    s, bmax = bf_scan(q, base, sq, VectorMetric.L2)
    with pytest.raises(ValueError, match="k <= 128"):
        bf_select(s, bmax, torch.zeros(4), S_SLOTS + 1)


def test_build_paths_follow_the_source():
    """The library is named by the hash of its source and lives in the
    ignored build directory; resolving it needs no nvcc."""
    for name in ("bf_scan", "bf_select"):
        p = _build.library_path(name)
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
    assert _build.library_path("bf_scan") != _build.library_path("bf_select")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# --- CUDA kernels vs their plain versions (skip without a card) ------------

@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_bf_scan_matches_plain(cuda_device, metric):
    q, base, sq = _t(*_inputs(13, 64, metric), device=cuda_device)
    s, bmax = bf_scan(q, base, sq, metric)
    s_p, bmax_p = bf_scan_plain(q, base, sq, metric)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(bmax, bmax_p, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n,d", [(64, 8192, 128), (1, 8192, 128),
                                     (5, 640, 100), (70, 192, 37),
                                     (130, 1088, 256), (100, 2048, 128),
                                     (9, 1024, 128)])
def test_cuda_bf_scan_is_fp32_accurate(cuda_device, n_q, n, d):
    """K1 stays within 8 fp32 ulps of sum_d |q_d b_d| of the float64
    product on every path of the kernel (Q <= 8 in fp32 FMA; the 3xTF32
    wgmma with the query group resident, D <= 128, or streamed, D > 128;
    D % 4 != 0 without tensor maps; Q > 64; N % 128 == 64), and its bmax is
    the block max of its S."""
    q, base, sq = _t(*_inputs(16, n_q, VectorMetric.INNER_PRODUCT, n=n, d=d),
                     device=cuda_device)
    s, bmax = bf_scan(q, base, sq, VectorMetric.INNER_PRODUCT)
    q64, b64 = q.double(), base.double()
    err = (s.double() - (q64 @ b64.T - sq.double()[None, :])).abs()
    mag = q64.abs() @ b64.abs().T + sq.double().abs()[None, :]
    assert (err <= 8 * torch.finfo(torch.float32).eps * mag).all()
    assert torch.equal(bmax, s.view(n_q, -1, 64).amax(dim=2))


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,d", [(1, 16), (8, 16), (1, 32), (8, 32)])
def test_cuda_bf_scan_small_q_over_many_tiles(cuda_device, n_q, d):
    """Q <= 8 with one D-chunk a tile, 1,024 tiles over the card's CTAs:
    each tile's sq_eff buffer is refilled two tiles later, and every row
    still scores with its own sq_eff (L2, within 8 fp32 ulps of the float64
    product)."""
    n = 131072
    q, base, sq = _t(*_inputs(18, n_q, VectorMetric.L2, n=n, d=d),
                     device=cuda_device)
    s, bmax = bf_scan(q, base, sq, VectorMetric.L2)
    q64, b64, sq64 = q.double(), base.double(), sq.double()
    err = (s.double() - (2 * q64 @ b64.T - sq64[None, :])).abs()
    mag = 2 * q64.abs() @ b64.abs().T + sq64.abs()[None, :]
    assert (err <= 8 * torch.finfo(torch.float32).eps * mag).all()
    assert torch.equal(bmax, s.view(n_q, -1, 64).amax(dim=2))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 100, 128])
def test_cuda_bf_select_matches_plain(cuda_device, k):
    q, base, sq = _t(*_inputs(14, 64, VectorMetric.L2), device=cuda_device)
    s, bmax = bf_scan(q, base, sq, VectorMetric.L2)
    eps = torch.zeros(64, device=cuda_device)
    o_s, o_i, o_f = bf_select(s, bmax, eps, k)
    p_s, p_i, p_f = bf_select_plain(s, bmax, eps, k)
    assert torch.equal(o_s, p_s) and float(o_f.max()) == 0.0
    for b in range(64):
        assert set(o_i[b].tolist()) == set(p_i[b].tolist())


@pytest.mark.cuda
def test_cuda_bf_select_streams_wide_bmax(cuda_device):
    """Above 16,384 blocks K2 reads the block maxima from device memory
    instead of staging them; it still equals its plain version."""
    rng = np.random.default_rng(17)
    s = torch.from_numpy(rng.normal(size=(2, 64 * 20000)).astype(
        np.float32)).to(cuda_device)
    bmax = s.view(2, -1, 64).amax(dim=2)
    eps = torch.zeros(2, device=cuda_device)
    for got, want in zip(bf_select(s, bmax, eps, 100),
                         bf_select_plain(s, bmax, eps, 100)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_fused_edge_cases(cuda_device):
    """Fewer valid rows than k, and mass ties raising the flag, on the card."""
    rng = np.random.default_rng(15)
    base = np.zeros((N, D), np.float32)
    base[:7] = rng.normal(size=(7, D))
    sq = np.full(N, SQ_EFF_BIG, np.float32)
    sq[:7] = (base[:7] ** 2).sum(1)
    q = rng.normal(size=(3, D)).astype(np.float32)
    s, i, flag = knn_scan_fused(*_t(q, base, sq, device=cuda_device), 64,
                                VectorMetric.L2)
    assert float(flag.max()) == 0.0
    assert sorted(i[0, :7].tolist()) == list(range(7))
    assert (i[:, 7:] == -1).all()
    tied = np.tile(base[:1], (N, 1))
    _, _, flag = knn_scan_fused(
        *_t(q, tied, (tied ** 2).sum(1), device=cuda_device), 32,
        VectorMetric.L2)
    assert (flag > 0).all()
