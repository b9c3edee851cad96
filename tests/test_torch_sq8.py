"""reindexer_tpu_torch's SQ8 brute-force select vs reindexer_tpu's, on the same
seeded numpy inputs.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances, each with its reason:
  - K3 scores: abs <= 2^-15 * fac * 255 * sum_d |q_alpha[q, d]| per query,
    since the JAX product (_dot2, pallas_scan.py:280) keeps 16 bits of
    q_alpha where the port keeps 24;
  - approximate top-k: ids equal as sets up to ties at the k-th quantized
    score, scores rtol 1e-6 (the same integer dots, scaled in fp32);
  - exact top-k: ids equal up to near-ties within 64 * eps_f32 * max|q.b|
    (tests/test_pallas_select.py:106-119), scores atol 8e-6 * max|q.b|;
  - engine results: ids equal to the float64 oracle's up to near-ties at
    the k-th rank (rtol 1e-4), ranks rtol 1e-4.
Tests marked `cuda` hold the port on the card against the port on the CPU
and each SQ8 kernel against its plain version; they skip without a card and
import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sq8.py
"""
import numpy as np
import pytest
import torch

from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexType,
                                 KnnSearchParams, ParamsError,
                                 QuantizationConfig, VectorMetric)
from reindexer_tpu_torch.convert import (keeper_state_from_reference,
                                         quant_state_from_reference)
from reindexer_tpu_torch.index.vector import brute_force
from reindexer_tpu_torch.index.vector.brute_force import BruteForceIndex
from reindexer_tpu_torch.index.vector.quantization import (QuantizedStore,
                                                           knn_scan_quantized)
from reindexer_tpu_torch.ops.hnsw_kernels import exact_rescore
from reindexer_tpu_torch.ops.scan import (BLK, SENT_HALF, SQ_EFF_BIG,
                                          bf16_limbs, sq8_i8_scan,
                                          sq8_i8_scan_plain, sq8_scan,
                                          sq8_scan_plain)
from reindexer_tpu_torch.ops import select as select_mod
from reindexer_tpu_torch.ops.select import (MARGIN, S_SLOTS,
                                            knn_scan_approx_sq8,
                                            knn_scan_sq8, sq8_select,
                                            sq8_select_plain)

# this file runs beside timing-sensitive tests (the TCP cluster's raft
# timeouts) when the suite is spread over processes: a small intra-op pool
# keeps torch from taking every core
torch.set_num_threads(2)

N, D = 2 * 8192, 128
TILE = 8192
METRICS = [VectorMetric.L2, VectorMetric.INNER_PRODUCT]
EPS_MODES = ["cert", "fast"]
RTOL = 1e-4
COUNTERS = ("geometry_scans", "overflow_reruns", "approx_reruns",
            "sq8_cert_overflows", "sq8_fast_overflows")


def _ref():
    """The JAX package's ops, imported here rather than at module level so
    that the `cuda` tests of this file run where JAX is absent."""
    import jax.numpy as jnp
    from reindexer_tpu.ops import hnsw_kernels, pallas_scan, pallas_select
    from reindexer_tpu.index.vector import quantization
    return jnp, pallas_scan, pallas_select, quantization, hnsw_kernels


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _fac(metric):
    return 2.0 if metric == VectorMetric.L2 else 1.0


def _sq8_inputs(seed, n_q, metric, clustered=False, n=N, d=D,
                invalid=(7,), cluster_rows=64, spread=10.0):
    """q, base, sq_eff and the 0.001 / 0.999 quantile grid with its codes
    and per-dimension error bounds, as numpy. Invalid rows are zeroed (the
    JAX kernels' contract) and carry sq_eff = SQ_EFF_BIG (the port's).
    clustered: block-coherent clusters, each run of cluster_rows rows around
    its own center, centers `spread` times the noise's 10-fold
    (tests/test_pallas_select.py:66-79 with 64-row runs)."""
    rng = np.random.default_rng(seed)
    if clustered:
        n_cl = n // cluster_rows
        centers = rng.normal(size=(n_cl, d)).astype(np.float32) * spread
        base = (np.repeat(centers, cluster_rows, axis=0)
                + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
        q = (centers[rng.integers(0, n_cl, size=n_q)]
             + 0.3 * rng.normal(size=(n_q, d))).astype(np.float32)
    else:
        base = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(n_q, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[list(invalid)] = False
    base[~valid] = 0.0
    lo = np.quantile(base[valid], 0.001, axis=0).astype(np.float32)
    hi = np.quantile(base[valid], 0.999, axis=0).astype(np.float32)
    alpha = np.maximum((hi - lo) / 255.0, 1e-12).astype(np.float32)
    codes = np.clip(np.round((np.clip(base, lo, hi) - lo) / alpha),
                    0, 255).astype(np.uint8)
    resid = np.abs(base - (lo + alpha * codes))[valid]
    err = resid.max(axis=0).astype(np.float32)
    ms = (resid * resid).mean(axis=0).astype(np.float32)
    sq = ((base * base).sum(1) if metric == VectorMetric.L2
          else np.zeros(n)).astype(np.float32)
    sq[~valid] = SQ_EFF_BIG
    return q, base, sq, codes, lo, alpha, err, ms


def _k3_tol(q_alpha, metric):
    return 2.0 ** -15 * _fac(metric) * 255.0 * np.abs(q_alpha).sum(1)


def _tied_or_equal(got, want, score_of, kth, tol):
    """Ids in exactly one of got / want must score within tol of kth."""
    for r in set(got) ^ set(want):
        assert abs(score_of(r) - kth) <= tol, (r, score_of(r), kth)


# --- K3 plain vs the JAX package's SQ8 scans -------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_sq8_scan_plain_matches_pass1_sq8(metric):
    """S mode (shift 0) against pallas_scan._pass1_sq8: scores and block
    maxima."""
    jnp, pallas_scan, _, _, _ = _ref()
    q, base, sq, codes, lo, alpha, _, _ = _sq8_inputs(1, 8, metric,
                                                      invalid=(5, 9001))
    qa = q * alpha
    ps, bmax = pallas_scan._pass1_sq8(jnp.asarray(qa), jnp.asarray(codes),
                                      jnp.asarray(sq), pallas_scan.TILE,
                                      metric, interpret=True)
    ps, bmax = np.asarray(ps), np.asarray(bmax).T
    s, bm = sq8_scan(*_t(qa, codes, sq, np.zeros(8, np.float32)), metric)
    s, bm = s.numpy(), bm.numpy()
    tol = _k3_tol(qa, metric)[:, None]
    valid = sq < SQ_EFF_BIG / 2
    assert (np.abs(s[:, valid] - ps[:, valid]) <= tol).all()
    assert (s[:, ~valid] <= SENT_HALF).all()
    assert (ps[:, ~valid] <= SENT_HALF).all()
    assert (np.abs(bm - bmax) <= tol).all()


@pytest.mark.parametrize("metric", METRICS)
def test_sq8_scan_bmax_only_matches_sweep_bmax_sq8(metric):
    """bmax-only mode with shift = fac * q.lo against
    pallas_select.sweep_bmax_sq8; no S is produced."""
    jnp, _, pallas_select, _, _ = _ref()
    q, base, sq, codes, lo, alpha, _, _ = _sq8_inputs(2, 8, metric)
    qa = q * alpha
    shift = (_fac(metric) * (q @ lo)).astype(np.float32)
    want = np.asarray(pallas_select.sweep_bmax_sq8(
        jnp.asarray(qa), jnp.asarray(shift[None, :]), jnp.asarray(codes),
        jnp.asarray(sq), metric, interpret=True)).T
    s, bm = sq8_scan(*_t(qa, codes, sq, shift), metric, with_s=False)
    assert s is None
    assert (np.abs(bm.numpy() - want) <= _k3_tol(qa, metric)[:, None]).all()


@pytest.mark.parametrize("scale", [2.0 ** -100, 1e-3, 1.0, 1e5, 2.0 ** 120])
def test_bf16_limbs_reconstruct_q_alpha(scale):
    """K3's split of q_alpha into three bf16 limbs (ops/scan.py's copy of
    the kernel's): hi + mid + lo equals the fp32 value bit for bit, over
    the range K3 is fed, and each limb is a bf16."""
    rng = np.random.default_rng(29)
    mag = (0.5 + np.abs(rng.normal(size=20000))) * scale   # >= scale / 2
    x = torch.from_numpy((np.sign(rng.normal(size=20000)) * mag).astype(
        np.float32))
    x[:4] = torch.tensor([0.0, -0.0, scale, -scale])
    limbs = bf16_limbs(x)
    assert all(limb.dtype == torch.bfloat16 for limb in limbs)
    hi, mid, lo = (limb.to(torch.float32) for limb in limbs)
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi, x.to(torch.bfloat16).to(torch.float32))
    # two limbs (TPU's _dot2 keeps 16 bits) do not reconstruct it
    assert not torch.equal(hi + mid, x)


# --- K5 plain + K2 plain vs the JAX approximate SQ8 kernel -----------------

def _approx_pair(q, codes, lo, alpha, sq, k, metric):
    jnp, _, pallas_select, _, _ = _ref()
    codes_i8 = (codes.astype(np.int32) - 128).astype(np.int8)
    s_r, i_r, f_r = pallas_select.knn_scan_approx_sq8_v4(
        jnp.asarray(q[None]), jnp.asarray(codes_i8), jnp.asarray(lo),
        jnp.asarray(alpha), jnp.asarray(sq), k, metric, interpret=True)
    s, i, flag = knn_scan_approx_sq8(*_t(q, codes, lo, alpha, sq), k, metric)
    assert float(f_r) == 0.0 and float(flag.max()) == 0.0
    return np.asarray(s_r)[0], np.asarray(i_r)[0], s.numpy(), i.numpy()


def _quantized_oracle(q, codes, alpha, sq, metric):
    """The int8 scores in float64: fac * s_q * (qa_i8 . (codes - 128)) -
    sq_eff (the ranking both kernels select on)."""
    qa = q * alpha[None, :]
    s_q = np.maximum(np.abs(qa).max(1), 1e-30) / 127.0
    qa_i8 = np.round(qa / s_q[:, None]).astype(np.int64)
    dots = qa_i8 @ (codes.astype(np.int64) - 128).T
    return (_fac(metric) * s_q[:, None].astype(np.float64) * dots
            - sq[None, :].astype(np.float64))


@pytest.mark.parametrize("metric", METRICS)
def test_approx_sq8_matches_approx_v4(metric):
    q, base, sq, codes, lo, alpha, _, _ = _sq8_inputs(3, 8, metric,
                                                      invalid=())
    k = 37
    s_r, i_r, s, i = _approx_pair(q, codes, lo, alpha, sq, k, metric)
    oracle = _quantized_oracle(q, codes, alpha, sq, metric)
    for b in range(len(q)):
        kth = np.sort(oracle[b])[-k]
        _tied_or_equal(i[b].tolist(), i_r[b].tolist(),
                       lambda r: oracle[b, r], kth, 1e-6 * abs(kth))
    np.testing.assert_allclose(s, s_r, rtol=1e-6)


def test_approx_sq8_invalid_rows():
    """Half the rows invalid (sq_eff = SQ_EFF_BIG): neither side returns
    one, and the ids agree (tests/test_pallas_select.py:593)."""
    rng = np.random.default_rng(4)
    invalid = rng.choice(N, size=N // 2, replace=False)
    q, base, sq, codes, lo, alpha, _, _ = _sq8_inputs(
        4, 8, VectorMetric.L2, invalid=invalid)
    s_r, i_r, s, i = _approx_pair(q, codes, lo, alpha, sq, 20,
                                  VectorMetric.L2)
    assert not np.isin(i, invalid).any() and not np.isin(i_r, invalid).any()
    for b in range(len(q)):
        assert set(i[b].tolist()) == set(i_r[b].tolist())


# --- K4 plain (through knn_scan_sq8) vs the JAX exact SQ8 kernels ----------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("eps_mode", EPS_MODES)
@pytest.mark.parametrize("ref_fn", ["knn_scan_sq8_v3", "knn_scan_sq8_v2"])
def test_knn_scan_sq8_matches_reference(metric, eps_mode, ref_fn):
    """Block-coherent clustered data: no flag on either side, and the same
    exact top-k up to near-ties of the fp32 dot-form scores."""
    jnp, _, pallas_select, _, _ = _ref()
    q, base, sq, codes, lo, alpha, err, ms = _sq8_inputs(5, 8, metric,
                                                         clustered=True)
    k = 10
    s_r, i_r, f_r = getattr(pallas_select, ref_fn)(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(lo),
        jnp.asarray(alpha), jnp.asarray(err), jnp.asarray(sq),
        jnp.asarray(base), k, metric, interpret=True, eps_mode=eps_mode,
        ms_dims=jnp.asarray(ms))
    s, i, flag = knn_scan_sq8(*_t(q, codes, lo, alpha, err, ms, sq, base),
                              k, metric, eps_mode)
    assert float(f_r) <= 0.0 and float(flag.max()) == 0.0
    s_r, i_r, s, i = np.asarray(s_r), np.asarray(i_r), s.numpy(), i.numpy()
    assert not np.isin(i, [7]).any()
    q64, b64 = q.astype(np.float64), base.astype(np.float64)
    ref = (((q64[:, None, :] - b64[None]) ** 2).sum(-1)
           if metric == VectorMetric.L2 else -(q64 @ b64.T))
    scale = float(np.abs(q @ base.T).max())
    tol = 64.0 * np.finfo(np.float32).eps * scale
    for b in range(len(q)):
        kth = np.sort(ref[b])[k - 1]
        _tied_or_equal(i[b].tolist(), i_r[b].tolist(), lambda r: ref[b, r],
                       kth, 2 * tol)
    np.testing.assert_allclose(s, s_r, atol=8e-6 * scale)


def test_knn_scan_sq8_cert_flags_isotropic():
    """On isotropic data the certified eps admits more than 128 blocks: the
    port flags where the reference flags (tests/test_pallas_select.py:148)."""
    jnp, _, pallas_select, _, _ = _ref()
    q, base, sq, codes, lo, alpha, err, ms = _sq8_inputs(
        6, 8, VectorMetric.L2, invalid=())
    _, _, f_r = pallas_select.knn_scan_sq8_v3(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(lo),
        jnp.asarray(alpha), jnp.asarray(err), jnp.asarray(sq),
        jnp.asarray(base), 10, VectorMetric.L2, interpret=True)
    _, _, flag = knn_scan_sq8(*_t(q, codes, lo, alpha, err, ms, sq, base),
                              10, VectorMetric.L2, "cert")
    assert float(f_r) > 0.0 and (flag > 0).all()


def test_sq8_select_plain_contract():
    """K4's threshold sits at the (k + 4)-th valid block max minus eps:
    k + 4 blocks are admitted at eps 0, every valid block (and the flag)
    once eps is huge, all valid blocks when fewer than k + 4 are valid."""
    rng = np.random.default_rng(7)
    n_q, n, k = 2, 64 * 300, 16
    q = rng.normal(size=(n_q, 8)).astype(np.float32)
    base = rng.normal(size=(n, 8)).astype(np.float32)
    sq = (base * base).sum(1).astype(np.float32)
    bmax = torch.from_numpy(rng.normal(size=(n_q, n // 64)).astype(
        np.float32))
    bmax[:, :3] = -1e30                                   # invalid blocks
    args = _t(q, base, sq)
    zero = torch.zeros(n_q)
    s, i, flag = sq8_select_plain(bmax, zero, *args, k, VectorMetric.L2)
    assert (flag == 0).all()
    admitted = set((i[0].numpy() // 64).tolist())
    top_blocks = set(torch.topk(bmax[0], k + 4).indices.tolist())
    assert admitted <= top_blocks
    exact = 2 * q @ base.T - sq
    rows = np.concatenate([np.arange(64 * g, 64 * g + 64)
                           for g in sorted(top_blocks)])
    want = np.sort(exact[0, rows])[::-1][:k]
    np.testing.assert_allclose(s[0].numpy(), want, rtol=1e-6)
    _, _, over = sq8_select_plain(bmax, zero + 100.0, *args, k,
                                  VectorMetric.L2)
    assert (over > 0).all()                # 297 valid blocks > 128 slots
    few = torch.full_like(bmax, -1e30)
    few[:, 10:15] = 1.0                    # 5 valid blocks < k + 4
    s, i, flag = sq8_select_plain(few, zero, *args, k, VectorMetric.L2)
    assert (flag == 0).all() and set((i[0].numpy() // 64).tolist()) <= set(
        range(10, 15))
    with pytest.raises(ValueError, match="k <= 124"):
        sq8_select(bmax, zero, *args, 125, VectorMetric.L2)


# --- QuantizedStore and the plain scans vs the JAX package's ---------------

def _quant_def(dims, metric=VectorMetric.L2, mode="exact", min_elements=64):
    return IndexDef("vec", IndexType.VEC_BF, vector_opts=FloatVectorOpts(
        dims=dims, metric=metric, quantization=QuantizationConfig(
            enabled=True, min_elements=min_elements, mode=mode)))


def _index_pair(dims, metric=VectorMetric.L2, min_elements=64):
    from reindexer_tpu.index.vector.brute_force import \
        BruteForceIndex as RefIndex
    idef = _quant_def(dims, metric, min_elements=min_elements)
    return RefIndex(idef), BruteForceIndex(idef, torch.device("cpu"))


def _assert_same_store(ref_ix, ix):
    rs, ps = ref_ix._quant, ix._quant
    assert rs.active == ps.active
    if not rs.active:
        return
    np.testing.assert_array_equal(ps.lo.numpy(), np.asarray(rs.lo))
    np.testing.assert_array_equal(ps.alpha.numpy(), np.asarray(rs.alpha))
    valid = np.asarray(ref_ix.keeper.valid)
    assert ps.codes.shape == tuple(rs.codes.shape)
    np.testing.assert_array_equal(ps.codes.numpy()[valid],
                                  np.asarray(rs.codes)[valid])
    np.testing.assert_allclose(ps.err_dims.numpy(), np.asarray(rs.err_dims),
                               rtol=1e-6)
    np.testing.assert_allclose(ps.ms_dims.numpy(), np.asarray(rs.ms_dims),
                               rtol=1e-6)
    assert ps.memstat() == rs.memstat()
    assert ps._quantized_count == rs._quantized_count


@pytest.mark.parametrize("n, dims", [(300, 16), (70000, 8)])
def test_quantized_store_matches_reference(n, dims):
    """Same rows into both engines (70,000 rows exercise the 65,536-row
    quantile sample), then the same mutations: the grids are bit for bit
    equal, so are the codes of every valid row, and both stores decide to
    re-encode or re-quantize at the same steps."""
    ref_ix, ix = _index_pair(dims)
    rng = np.random.default_rng(8)

    def rows(lo, hi, shift=0.0):
        return {r: (shift + rng.normal(size=dims)).astype(np.float32)
                for r in range(lo, hi)}

    bulk = rng.normal(size=(n, dims)).astype(np.float32)
    grow = rng.normal(size=(n + 10, dims)).astype(np.float32)
    steps = [("load", bulk, 0), ("delete", dict.fromkeys(range(0, 40, 3)), 0),
             ("upsert", rows(n, n + 25), 0),
             ("drift", rows(n + 25, n + 30, shift=10.0), 0),
             ("load", grow, n + 30)]
    for op, muts, start in steps:
        for kx in (ref_ix, ix):
            if op == "load":
                kx.keeper.bulk_load(muts, start_row=start)
            for r, v in (muts.items() if op != "load" else ()):
                if v is None:
                    kx.delete(r, None)
                else:
                    kx.upsert(r, v)
            kx.keeper.flush()
        decisions = [(kx._quant.need_requantize(kx.keeper.count,
                                                kx.keeper.capacity),
                      kx._quant.need_refresh(kx.keeper.count))
                     for kx in (ref_ix, ix)]
        assert decisions[0] == decisions[1], (op, decisions)
        for kx in (ref_ix, ix):
            kx._maybe_quantize()
        _assert_same_store(ref_ix, ix)


def test_quant_state_round_trips():
    """The JAX store's state_dict converts, loads into the port's store on
    the same keeper state, re-encodes to the same codes and saves back to
    the same state."""
    ref_ix, _ = _index_pair(16)
    rng = np.random.default_rng(9)
    ref_ix.keeper.bulk_load(rng.normal(size=(500, 16)).astype(np.float32))
    ref_ix.delete(3, None)
    ref_ix._maybe_quantize()
    ix = BruteForceIndex(_quant_def(16), torch.device("cpu"))
    ix.load_state_dict({"keeper": keeper_state_from_reference(
        ref_ix.keeper.state_dict())})
    state = quant_state_from_reference(ref_ix._quant.state_dict())
    ix._quant.load_state_dict(state, ix.keeper)
    _assert_same_store(ref_ix, ix)
    back = ix._quant.state_dict()
    assert back.keys() == state.keys()
    for key in ("lo", "alpha"):
        np.testing.assert_array_equal(back[key], state[key])
    assert back["quantized_count"] == state["quantized_count"] == 499
    assert quant_state_from_reference({}) == {}
    empty = QuantizedStore(0.001, 0.999, 64)
    empty.load_state_dict({}, ix.keeper)
    assert not empty.active and empty.state_dict() == {}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("chunk", [262144, 1024])
def test_knn_scan_quantized_matches_reference(metric, chunk):
    jnp, _, _, quantization, _ = _ref()
    q, base, sq, codes, lo, alpha, _, _ = _sq8_inputs(10, 5, metric, n=4096,
                                                      invalid=(3, 100))
    valid = sq < SQ_EFF_BIG / 2
    k = 50
    s_r, i_r = quantization.knn_scan_quantized(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(lo),
        jnp.asarray(alpha), jnp.asarray(valid), jnp.asarray(sq), k, metric,
        chunk=chunk)
    s, i = knn_scan_quantized(*_t(q, codes, lo, alpha, valid, sq), k, metric,
                              chunk=chunk)
    s_r, i_r, s, i = np.asarray(s_r), np.asarray(i_r), s.numpy(), i.numpy()
    assert i.dtype == np.int32 and valid[i].all()
    np.testing.assert_allclose(s, s_r, rtol=1e-5, atol=1e-5)
    for b in range(len(q)):
        score = dict(zip(i_r[b].tolist(), s_r[b].tolist()))
        score.update(zip(i[b].tolist(), s[b].tolist()))
        _tied_or_equal(i[b].tolist(), i_r[b].tolist(), score.get,
                       s_r[b, -1], 1e-5 * abs(s_r[b, -1]))


@pytest.mark.parametrize("metric", METRICS)
def test_exact_rescore_matches_reference(metric):
    jnp, _, _, _, hnsw_kernels = _ref()
    rng = np.random.default_rng(11)
    data = rng.normal(size=(500, 32)).astype(np.float32)
    sq = (data * data).sum(1).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    ids = rng.choice(500, size=(4, 12)).astype(np.int32)
    ids[1, 9:] = -1                                       # padding
    scores_in = rng.normal(size=(4, 12)).astype(np.float32)
    scores_in[ids < 0] = -np.inf
    s_r, i_r = hnsw_kernels.exact_rescore(
        jnp.asarray(q), jnp.asarray(data), jnp.asarray(sq), jnp.asarray(ids),
        jnp.asarray(scores_in), metric)
    s, i = exact_rescore(*_t(q, data, sq, ids, scores_in), metric)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_r))
    assert (i[1, 9:] == -1).all() and torch.isinf(s[1, 9:]).all()


# --- the engine on the CPU --------------------------------------------------

def _port_index(dims, metric=VectorMetric.L2, mode="exact", min_elements=64,
                device="cpu"):
    return BruteForceIndex(_quant_def(dims, metric, mode, min_elements),
                           torch.device(device))


def _oracle(base, q, metric, alive=None):
    """float64 ranks [Q, N] (L2 squared distance, IP similarity negated so
    that smaller is better everywhere), inf for dead rows."""
    b, qq = base.astype(np.float64), q.astype(np.float64)
    if metric == VectorMetric.L2:
        d = (b * b).sum(1)[None, :] - 2.0 * qq @ b.T + (qq * qq).sum(1)[:, None]
    else:
        d = -(qq @ b.T)
    if alive is not None:
        d[:, ~alive] = np.inf
    return d


def _assert_exact(results, dist, k, metric):
    for qi, res in enumerate(results):
        row = dist[qi]
        want = np.argsort(row, kind="stable")[:k]
        kth = row[want[-1]]
        assert len(res.ids) == min(k, np.isfinite(row).sum())
        _tied_or_equal(res.ids.tolist(), want.tolist(), lambda r: row[r],
                       kth, RTOL * max(abs(kth), 1.0))
        got = row[res.ids]
        ranks = got if metric == VectorMetric.L2 else -got
        np.testing.assert_allclose(res.ranks, ranks, rtol=RTOL, atol=1e-3)


def _reset_counters():
    for name in COUNTERS:
        getattr(brute_force, name).reset()


def _counts():
    return {name: getattr(brute_force, name).value for name in COUNTERS}


@pytest.fixture(scope="module")
def exact_5k():
    """5,000 rows x 32 in exact SQ8 mode, 200 deleted (capacity 8192: 128
    blocks), per metric."""
    rng = np.random.default_rng(12)
    base = rng.normal(size=(5000, 32)).astype(np.float32)
    alive = np.ones(5000, bool)
    alive[rng.choice(5000, size=200, replace=False)] = False
    out = {}
    for metric in METRICS:
        ix = _port_index(32, metric)
        ix.keeper.bulk_load(base)
        for r in np.flatnonzero(~alive):
            ix.delete(int(r), None)
        out[metric] = ix
    return out, base, alive


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_q", [1, 3, 64, 100, 256])
def test_exact_sq8_equals_oracle(exact_5k, metric, n_q):
    """select (n_q = 1) and knn_batch of 3, 64, 100 and 256 queries return
    the float64 oracle's top-k through K3 + K4. Above 128 queries the JAX
    engine on a TPU falls to its approximate scan (finding 2,
    pallas_select.py:1703-1707); the port stays exact."""
    ixs, base, alive = exact_5k
    ix = ixs[metric]
    q = np.random.default_rng(13 + n_q).normal(size=(n_q, 32)).astype(
        np.float32)
    _reset_counters()
    params = KnnSearchParams(k=50)
    res = ([ix.select(q[0], params)] if n_q == 1
           else ix.select_batch(q, params))
    assert ix._quant.active and ix._sq8_mode == "cert"
    assert _counts() == dict.fromkeys(COUNTERS, 0)
    _assert_exact(res, _oracle(base, q, metric, alive), 50, metric)


@pytest.mark.parametrize("k", [125, 126, 127, 128, 200])
def test_exact_sq8_large_k_runs_fp32(exact_5k, k):
    """k > 124 leaves no room for K4's 4 margin blocks: the fp32 path
    serves it, exactly, and each select is counted. The JAX engine on a TPU
    falls to its approximate scan there (finding 2)."""
    ixs, base, alive = exact_5k
    ix = ixs[VectorMetric.L2]
    q = np.random.default_rng(14).normal(size=(3, 32)).astype(np.float32)
    _reset_counters()
    res = ix.select_batch(q, KnnSearchParams(k=k))
    assert _counts()["geometry_scans"] == 1
    _assert_exact(res, _oracle(base, q, VectorMetric.L2, alive), k,
                  VectorMetric.L2)


def test_exact_sq8_ladder_cert_to_fast_is_sticky():
    """Isotropic data overflows the certified eps: the batch reruns with the
    fast eps, which serves it, and the index stays on fast; results equal
    the oracle's (tests/test_pallas_select.py:123)."""
    q, base, _, _, _, _, _, _ = _sq8_inputs(15, 8, VectorMetric.L2,
                                            invalid=())
    ix = _port_index(D)
    ix.keeper.bulk_load(base)
    _reset_counters()
    for _ in range(2):
        res = ix.select_batch(q, KnnSearchParams(k=10))
        _assert_exact(res, _oracle(base, q, VectorMetric.L2), 10,
                      VectorMetric.L2)
    assert ix._sq8_mode == "fast"
    assert _counts() == {**dict.fromkeys(COUNTERS, 0),
                         "sq8_cert_overflows": 1}


def test_exact_sq8_ladder_mass_ties_reach_fp32():
    """16,384 identical vectors tie every block max: cert, then fast, then
    the fp32 K1 + K2 overflow, and the plain scan answers, exactly."""
    one = np.random.default_rng(16).normal(size=(1, 8)).astype(np.float32)
    ix = _port_index(8)
    ix.keeper.bulk_load(np.tile(one, (16384, 1)))
    q = np.random.default_rng(17).normal(size=(3, 8)).astype(np.float32)
    _reset_counters()
    res = ix.select_batch(q, KnnSearchParams(k=32))
    assert _counts() == {**dict.fromkeys(COUNTERS, 0),
                         "sq8_cert_overflows": 1, "sq8_fast_overflows": 1,
                         "overflow_reruns": 1}
    for b, r in enumerate(res):
        assert len(r.ids) == 32 and (r.ids >= 0).all()
        np.testing.assert_allclose(r.ranks, ((q[b] - one[0]) ** 2).sum(),
                                   rtol=RTOL)


@pytest.mark.reference_divergence
def test_reference_exact_sq8_off_tpu_is_not_exact():
    """Finding 1: off a TPU the JAX engine's exact SQ8 mode returns the
    top-k of quantized scores (v2_available is False, so _dispatch_scan
    falls to _scan_quantized); on the same documents the port returns the
    float64 oracle's top-k. A deliberate difference (ROADMAP C)."""
    from reindexer_tpu.index.vector.brute_force import         BruteForceIndex as RefIndex
    rng = np.random.default_rng(18)
    base = rng.normal(size=(2000, 16)).astype(np.float32)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    dist = _oracle(base, q, VectorMetric.L2)
    ref_ix = RefIndex(_quant_def(16))
    ix = _port_index(16)
    for kx in (ref_ix, ix):
        kx.keeper.bulk_load(base)
    params = KnnSearchParams(k=10)
    ref_res = ref_ix.select_batch(q, params)
    assert ref_ix._quant.active
    misses = sum(set(r.ids.tolist()) != set(np.argsort(dist[b])[:10].tolist())
                 for b, r in enumerate(ref_res))
    assert misses > 0
    _assert_exact(ix.select_batch(q, params), dist, 10, VectorMetric.L2)


# --- the cases of tests/test_quantization.py, on the port ------------------

@pytest.mark.parametrize("mode", ["exact", "approx", "approx_rerank"])
def test_sq8_activates_at_min_elements(mode):
    rng = np.random.default_rng(19)
    ix = _port_index(8, mode=mode, min_elements=50)
    base = rng.normal(size=(60, 8)).astype(np.float32)
    for i in range(40):
        ix.upsert(i, base[i])
    ix.select(base[0], KnnSearchParams(k=1))
    assert not ix._quant.active
    for i in range(40, 60):
        ix.upsert(i, base[i])
    ix.select(base[0], KnnSearchParams(k=1))
    assert ix._quant.active


@pytest.mark.parametrize("mode", ["exact", "approx", "approx_rerank"])
def test_sq8_refresh_on_mutation(mode):
    rng = np.random.default_rng(20)
    ix = _port_index(8, mode=mode, min_elements=10)
    base = rng.normal(size=(30, 8)).astype(np.float32)
    for i in range(30):
        ix.upsert(i, base[i])
    ix.select(base[0], KnnSearchParams(k=1))
    assert ix._quant.active
    v = rng.normal(size=8).astype(np.float32)
    ix.upsert(99, v)                    # findable before a full requantize
    assert ix.select(v, KnnSearchParams(k=1)).ids[0] == 99
    ix.delete(99, None)                 # and gone from the codes once removed
    assert ix.select(v, KnnSearchParams(k=1)).ids[0] != 99


@pytest.mark.parametrize("mode", ["exact", "approx", "approx_rerank"])
def test_sq8_memstat_is_a_quarter(mode):
    rng = np.random.default_rng(21)
    ix = _port_index(16, mode=mode, min_elements=10)
    for i in range(32):
        ix.upsert(i, rng.normal(size=16).astype(np.float32))
    ix.select(np.zeros(16, np.float32), KnnSearchParams(k=1))
    st = ix.memstat()
    assert st["quantized"] and st["quantized_size"] * 4 == st["data_size"]
    assert ix._quant.codes.dtype == torch.uint8


@pytest.mark.parametrize("mode", ["exact", "approx", "approx_rerank"])
def test_sq8_requantize_on_quantile_drift(mode):
    """Data drifting outside the grid re-quantizes (new lo / alpha), and the
    drifted vectors are the nearest to their own region."""
    rng = np.random.default_rng(22)
    ix = _port_index(8, mode=mode, min_elements=10)
    for i in range(16):
        ix.upsert(i, rng.normal(size=8).astype(np.float32))
    ix.select(np.zeros(8, np.float32), KnnSearchParams(k=1))
    st = ix._quant
    hi0 = (st.lo + st.alpha * 255.0).numpy().copy()
    for i in range(16, 20):
        ix.upsert(i, (10.0 + rng.normal(size=8)).astype(np.float32))
    res = ix.select(np.full(8, 10.0, np.float32), KnnSearchParams(k=4))
    hi1 = (st.lo + st.alpha * 255.0).numpy()
    assert (hi1 > hi0 + 1.0).any(), (hi0, hi1)
    assert set(res.ids.tolist()) == {16, 17, 18, 19}


def test_sq8_mode_validation():
    with pytest.raises(ParamsError):
        _port_index(8, mode="bogus")


@pytest.mark.parametrize("metric", METRICS)
def test_approx_sq8_recall(metric):
    """Approx mode returns the quantized top-k directly, with high but not
    guaranteed recall (tests/test_quantization.py:157)."""
    rng = np.random.default_rng(23)
    base = rng.normal(size=(2000, 16)).astype(np.float32)
    ix = _port_index(16, metric, mode="approx")
    ix.keeper.bulk_load(base)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    dist = _oracle(base, q, metric)
    hits = sum(len(set(r.ids.tolist()) & set(np.argsort(dist[b])[:10]))
               for b, r in enumerate(ix.select_batch(q, KnnSearchParams(k=10))))
    assert hits / 80 >= 0.7, hits


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_q", [1, 100])
def test_approx_rerank_ranks_are_exact_fp32(metric, n_q):
    """approx_rerank: an approximate candidate set, ranked by the exact fp32
    metric of the returned ids (n_q = 100 runs K3 + K2, n_q = 1 K5 + K2)."""
    rng = np.random.default_rng(24)
    base = rng.normal(size=(1500, 16)).astype(np.float32)
    ix = _port_index(16, metric, mode="approx_rerank")
    ix.keeper.bulk_load(base)
    q = rng.normal(size=(n_q, 16)).astype(np.float32)
    dist = _oracle(base, q, metric)
    for b, r in enumerate(ix.select_batch(q, KnnSearchParams(k=8))):
        exact = dist[b][r.ids]
        want = exact if metric == VectorMetric.L2 else -exact
        np.testing.assert_allclose(r.ranks, want, rtol=1e-4, atol=1e-4)
        assert (np.diff(exact) >= -1e-4).all()      # best first


@pytest.mark.parametrize("mode", ["approx", "approx_rerank"])
def test_approx_large_k_runs_plain_quantized_scan(mode):
    rng = np.random.default_rng(25)
    base = rng.normal(size=(600, 16)).astype(np.float32)
    ix = _port_index(16, mode=mode)
    ix.keeper.bulk_load(base)
    _reset_counters()
    res = ix.select(base[4], KnnSearchParams(k=200))
    assert _counts()["geometry_scans"] == 1 and len(res.ids) == 200
    assert res.ids[0] == 4


def test_public_api_serves_all_three_modes():
    """One namespace, three SQ8 vec_bf fields over the same vectors, one per
    mode, through Reindexer.select and Reindexer.knn_batch (chip_smoke.py's
    SQ8 main path at a small size): exact equals the float64 oracle, approx
    recalls most of it, approx_rerank ranks are exact."""
    from types import SimpleNamespace

    from reindexer_tpu_torch import IndexOpts, Query, Reindexer
    rng = np.random.default_rng(28)
    base = rng.normal(size=(3000, 32)).astype(np.float32)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    dead = rng.choice(3000, size=50, replace=False)
    alive = np.ones(3000, bool)
    alive[dead] = False
    dist = _oracle(base, q, VectorMetric.L2, alive)
    modes = ("exact", "approx", "approx_rerank")
    db = Reindexer(device="cpu")
    db.open_namespace("sq8", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True))] + [
        IndexDef(m, "vec_bf", vector_opts=FloatVectorOpts(
            dims=32, metric=VectorMetric.L2, quantization=QuantizationConfig(
                enabled=True, min_elements=256, mode=m))) for m in modes])
    for i, row in enumerate(base.tolist()):
        db.upsert("sq8", {"id": i, **dict.fromkeys(modes, row)})
    for i in dead.tolist():
        db.delete("sq8", {"id": i})
    params = KnnSearchParams(k=20)

    def as_result(res):
        return SimpleNamespace(ids=np.array([d["id"] for d in res.docs()]),
                               ranks=np.asarray(res.ranks(), np.float32))

    for m in modes:
        res = [as_result(db.select(Query("sq8").where_knn(m, q[0], params)))]
        res += [as_result(r) for r in db.knn_batch("sq8", m, q, params)]
        dist2 = np.concatenate([dist[:1], dist])
        ix = db.get_namespace("sq8").get_index(m)
        assert isinstance(ix, BruteForceIndex) and ix._quant.active
        if m == "exact":
            _assert_exact(res, dist2, 20, VectorMetric.L2)
            continue
        assert not np.isin(np.concatenate([r.ids for r in res]), dead).any()
        hits = sum(len(set(r.ids.tolist()) & set(np.argsort(dist2[b])[:20]))
                   for b, r in enumerate(res))
        assert hits / (20 * len(res)) >= 0.8, (m, hits)
        if m == "approx_rerank":
            for b, r in enumerate(res):
                np.testing.assert_allclose(r.ranks, dist2[b][r.ids],
                                           rtol=1e-4, atol=1e-4)


# --- on the card (skip without one) -----------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_sq8_kernels_match_plain(cuda_device, metric):
    q, base, sq, codes, lo, alpha, err, ms = _sq8_inputs(26, 64, metric,
                                                         clustered=True)
    qa = (q * alpha).astype(np.float32)
    shift = (_fac(metric) * (q @ lo)).astype(np.float32)
    args = _t(qa, codes, sq, shift, device=cuda_device)
    # K3 sums on the tensor cores, in another order than the plain version's
    # fp32 matmul. Here scores are summed from up to ~1e5, where an fp32 ulp
    # is ~0.008: the two differ by more than atol 1e-3, and the plain
    # version is the further of the two from the float64 product (it is off
    # by more than 1e-3 at thousands of scores). So K3 is held to the
    # float64 product: within 8 fp32 ulps of the summed magnitude, and score
    # by score no further from it than the plain version's same score plus
    # 2 ulps (each bmax-only block max likewise against the plain version's,
    # plus 2 ulps of the block's largest magnitude); its bmax is its S's
    # block max in both modes.
    s, bm = sq8_scan(*args, metric)
    s_p, _ = sq8_scan_plain(*args, metric)
    _, bm_only = sq8_scan(*args, metric, with_s=False)
    _, bm_p = sq8_scan_plain(*args, metric, with_s=False)
    assert _k3_ulps(s, *args, _fac(metric)) <= 8.0
    qa64, c64, sq64, sh64 = (x.double() for x in args)
    exact = (_fac(metric) * (qa64 @ c64.T) - sq64[None, :]
             + sh64[:, None]).clamp_min(-1e30)
    ulps2 = 2.0 * torch.finfo(torch.float32).eps * (
        _fac(metric) * (qa64.abs() @ c64.T) + sq64.abs()[None, :]
        + sh64.abs()[:, None])
    valid = args[2] < SQ_EFF_BIG / 2
    e_k, e_p = (s.double() - exact).abs(), (s_p.double() - exact).abs()
    assert (e_k <= e_p + ulps2)[:, valid].all()
    exact_b = exact.view(64, -1, BLK).amax(dim=2)
    assert ((bm_only.double() - exact_b).abs()
            <= (bm_p.double() - exact_b).abs()
            + ulps2.view(64, -1, BLK).amax(dim=2)).all()
    assert torch.equal(bm, s.view(64, -1, BLK).amax(dim=2))
    assert torch.equal(bm_only, bm)
    qf, qa_t = _t(q, qa, device=cuda_device)
    s_q = qa_t.abs().amax(1).clamp_min(1e-30) / 127.0
    qa_i8 = torch.round(qa_t / s_q[:, None]).to(torch.int8)
    out = sq8_i8_scan(qa_i8, _fac(metric) * s_q, args[1], args[2])
    ref = sq8_i8_scan_plain(qa_i8, _fac(metric) * s_q, args[1], args[2])
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    _, bm = sq8_scan(*args, metric, with_s=False)
    eps = _t((_fac(metric) * (np.abs(q) * err).sum(1)).astype(np.float32),
             device=cuda_device)[0]
    base_t, = _t(base, device=cuda_device)
    o_s, o_i, o_f = sq8_select(bm, eps, qf, base_t, args[2], 10, metric)
    p_s, p_i, p_f = sq8_select_plain(bm, eps, qf, base_t, args[2], 10,
                                     metric)
    assert float(o_f.max()) == 0.0 and float(p_f.max()) == 0.0
    torch.testing.assert_close(o_s, p_s, rtol=1e-5, atol=1e-2)
    exact = (_fac(metric) * (q.astype(np.float64) @ base.T.astype(np.float64))
             - sq.astype(np.float64))
    for b in range(64):
        kth = float(p_s[b, -1])
        _tied_or_equal(o_i[b].tolist(), p_i[b].tolist(),
                       lambda r: exact[b, r], kth, 1e-5 * abs(kth) + 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "approx", "approx_rerank"])
def test_cuda_sq8_engine_matches_cpu(cuda_device, mode):
    rng = np.random.default_rng(27)
    base = rng.normal(size=(9000, 128)).astype(np.float32)
    q = rng.normal(size=(70, 128)).astype(np.float32)
    outs = []
    for device in ("cpu", cuda_device):
        ix = _port_index(128, mode=mode, device=device)
        ix.keeper.bulk_load(base)
        ix.delete(17, None)
        outs.append(ix.select_batch(q, KnnSearchParams(k=50)))
    for r_cpu, r_gpu in zip(*outs):
        assert 17 not in r_gpu.ids.tolist()
        rank_of = dict(zip(r_cpu.ids.tolist(), r_cpu.ranks.tolist()))
        rank_of.update(zip(r_gpu.ids.tolist(), r_gpu.ranks.tolist()))
        edge = float(r_cpu.ranks[-1])
        for i in set(r_cpu.ids.tolist()) ^ set(r_gpu.ids.tolist()):
            assert abs(rank_of[i] - edge) <= 1e-4 * abs(edge) + 1e-4, i
        np.testing.assert_allclose(r_gpu.ranks, r_cpu.ranks, rtol=1e-4,
                                   atol=1e-4)


# K3 on the card: every path of the kernel. Q = 1, 5 (N of a wgmma 8), 64,
# 130 (three query groups); D = 16, 128, 256 through tensor maps, 37 and 100
# through the producer's device-memory loads, 520 with the limbs split per
# window of D; N = 64 x 37 rows, so the persistent CTAs end on an odd tile.
K3_DS = [16, 37, 100, 128, 256, 520]


def _k3_case(seed, n_q, d, n=64 * 37):
    rng = np.random.default_rng(seed)
    qa = (0.02 * rng.normal(size=(n_q, d))).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, d), dtype=np.uint8)
    sq = (100.0 * rng.random(n)).astype(np.float32)
    sq[rng.choice(n, size=20, replace=False)] = SQ_EFF_BIG   # invalid rows
    shift = rng.normal(size=n_q).astype(np.float32)
    return qa, codes, sq, shift


def _k3_ulps(s, qa, codes, sq, shift, fac):
    """The largest error of s against the float64 product, in fp32 ulps of
    the magnitude a score is summed from: fac * sum_d |q_alpha_d code_d| +
    |sq_eff| + |shift|."""
    q64, c64 = qa.double(), codes.double()
    want = (fac * (q64 @ c64.T) - sq.double()[None, :]
            + shift.double()[:, None]).clamp_min(-1e30)
    mag = (fac * (q64.abs() @ c64.T) + sq.double().abs()[None, :]
           + shift.double().abs()[:, None])
    err = (s.double() - want).abs()
    return float((err / (torch.finfo(torch.float32).eps * mag)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", K3_DS)
@pytest.mark.parametrize("n_q", [1, 5, 64, 130])
def test_cuda_sq8_scan_both_modes(cuda_device, n_q, d, metric):
    """K3 against its plain version in S mode and bmax-only mode (rtol
    1e-5, atol 1e-3), within 8 fp32 ulps of the float64 product, with its
    bmax the block max of its S and the same in both modes."""
    qa, codes, sq, shift = _t(*_k3_case(30, n_q, d), device=cuda_device)
    s, bm = sq8_scan(qa, codes, sq, shift, metric)
    s_p, bm_p = sq8_scan_plain(qa, codes, sq, shift, metric)
    none, bm_only = sq8_scan(qa, codes, sq, shift, metric, with_s=False)
    assert none is None
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(bm, bm_p, rtol=1e-5, atol=1e-3)
    assert torch.equal(bm, s.view(n_q, -1, BLK).amax(dim=2))
    assert torch.equal(bm_only, bm)
    assert _k3_ulps(s, qa, codes, sq, shift, _fac(metric)) <= 8.0
    assert (s[:, sq >= SQ_EFF_BIG / 2] <= SENT_HALF).all()


@pytest.mark.cuda
def test_cuda_sq8_scan_one_limb_fails_the_ulps_check(cuda_device):
    """The control of the precision check: a product of one bf16 limb of
    q_alpha (a plain bf16 product) misses 8 ulps by far."""
    qa, codes, sq, shift = _t(*_k3_case(31, 64, 128), device=cuda_device)
    hi = bf16_limbs(qa)[0].to(torch.float32)
    s = (2.0 * (hi.double() @ codes.double().T) - sq.double()[None, :]
         + shift.double()[:, None]).float()
    assert _k3_ulps(s, qa, codes, sq, shift, 2.0) > 64.0


# K5 on the card: every path of the kernel. Q = 1, 5 (N of a wgmma 8), 64,
# 130 (three query groups); D = 128 and 768 through tensor maps, 13 and 100
# through the producer's device-memory loads; N = 64 x 37 rows, a multiple
# of 64 and not of 128. Codes 0 and 255 and query bytes +-127 are in every
# case.
K5_DS = [13, 100, 128, 768]


def _k5_case(seed, n_q, d, n=64 * 37):
    rng = np.random.default_rng(seed)
    qa = rng.integers(-127, 128, size=(n_q, d)).astype(np.int8)
    qa[0, : d // 2] = 127
    qa[-1, d // 2:] = -127
    codes = rng.integers(0, 256, size=(n, d), dtype=np.uint8)
    codes[:70] = 0
    codes[70:140] = 255
    sqscale = (1e-4 * (1.0 + rng.random(n_q))).astype(np.float32)
    sq = (100.0 * rng.random(n)).astype(np.float32)
    sq[rng.choice(n, size=20, replace=False)] = SQ_EFF_BIG   # invalid rows
    return qa, sqscale, codes, sq


def _assert_k5_bit_equal(qa, sqscale, codes, sq):
    s, bm = sq8_i8_scan(qa, sqscale, codes, sq)
    s_p, bm_p = sq8_i8_scan_plain(qa, sqscale, codes, sq)
    assert torch.equal(s, s_p)
    assert torch.equal(bm, bm_p)
    assert torch.equal(bm, s.view(qa.shape[0], -1, BLK).amax(dim=2))
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("d", K5_DS)
@pytest.mark.parametrize("n_q", [1, 5, 64, 130])
def test_cuda_sq8_i8_scan_bit_equal(cuda_device, n_q, d):
    """K5's S and bmax bit for bit equal to its plain version's, and its
    bmax the block max of its S."""
    s = _assert_k5_bit_equal(*_t(*_k5_case(32, n_q, d), device=cuda_device))
    assert s.shape == (n_q, 64 * 37)


@pytest.mark.cuda
def test_cuda_sq8_i8_scan_wide_sums_stay_exact(cuda_device):
    """At D = 70,000 the extreme rows' sums, 127 * 127 * D and -127 * -128
    * D, fit int32 only because K5 sums signed codes: u8 codes times the
    queries (127 * 255 * D) would pass 2^31. Scores are read with unit
    scale and no sq_eff, so S holds float(sum) itself."""
    d, n = 70_000, 192
    rng = np.random.default_rng(33)
    qa = rng.integers(-127, 128, size=(2, d)).astype(np.int8)
    qa[0] = 127
    qa[1] = -127
    codes = rng.integers(0, 256, size=(n, d), dtype=np.uint8)
    codes[0] = 255
    codes[1] = 0
    args = _t(qa, np.ones(2, np.float32), codes, np.zeros(n, np.float32),
              device=cuda_device)
    s = _assert_k5_bit_equal(*args)
    want = np.float32([[127 * 127 * d, -127 * 128 * d],
                       [-127 * 127 * d, 127 * 128 * d]])
    np.testing.assert_array_equal(s[:, :2].cpu().numpy(), want)
    assert 127 * 255 * d >= 2 ** 31


def _k4_check(o, p, exact, k):
    """K4 (o) against its plain version (p): the same flags; a flagged
    query's result is -inf / -1; an unflagged one has the plain version's
    scores (rtol 1e-4, atol 1e-3) and ids up to near-ties of the float64
    scores at the k-th."""
    flag = o[2].cpu().numpy() > 0
    assert (flag == (p[2].cpu().numpy() > 0)).all()
    o_s, o_i = o[0].cpu().numpy(), o[1].cpu().numpy()
    p_s, p_i = p[0].cpu().numpy(), p[1].cpu().numpy()
    assert (o_i[flag] == -1).all() and np.isneginf(o_s[flag]).all()
    ok = ~flag
    np.testing.assert_allclose(o_s[ok], p_s[ok], rtol=1e-4, atol=1e-3)
    for b in np.flatnonzero(ok):
        kth = float(p_s[b, -1])
        if np.isfinite(kth):
            _tied_or_equal([i for i in o_i[b].tolist() if i >= 0],
                           [i for i in p_i[b].tolist() if i >= 0],
                           lambda r: exact[b, r], kth,
                           1e-5 * abs(kth) + 1e-3)
        else:
            assert (o_i[b] == p_i[b]).all()
    return flag


def _k4_case(seed, n_q, metric, clustered, d=D, n=5 * 8192):
    """K4's inputs on the card, from the seeded SQ8 grid: K3's shifted
    block maxima, the certified eps, q, base, sq_eff; and the float64 exact
    scores. Clustered: clusters of 128 blocks (8,192 rows) with centers at 3
    (chip_smoke.py's layout), so a query admits its own cluster's blocks,
    at most 128, even at k = 124."""
    q, base, sq, codes, lo, alpha, err, _ = _sq8_inputs(
        seed, n_q, metric, clustered=clustered, n=n, d=d, invalid=(7, 300),
        cluster_rows=S_SLOTS * BLK, spread=3.0)
    fac = _fac(metric)
    qa = (q * alpha).astype(np.float32)
    shift = (fac * (q @ lo)).astype(np.float32)
    eps = (fac * (np.abs(q) * err).sum(1)).astype(np.float32)
    qa_t, codes_t, sq_t, shift_t, eps_t, q_t, base_t = _t(
        qa, codes, sq, shift, eps, q, base, device=torch.device("cuda", 0))
    _, bm = sq8_scan(qa_t, codes_t, sq_t, shift_t, metric, with_s=False)
    exact = (fac * (q.astype(np.float64) @ base.astype(np.float64).T)
             - sq.astype(np.float64))
    return (bm, eps_t, q_t, base_t, sq_t), exact


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 100, 124])
@pytest.mark.parametrize("n_q", [1, 64, 130])
@pytest.mark.parametrize("clustered", [True, False])
def test_cuda_sq8_select_matches_plain(cuda_device, clustered, n_q, k):
    """Clustered data: no query flags, and K4 gives the plain version's
    top k. Isotropic data: the certified eps admits more than 128 blocks,
    the same queries flag on both sides, and K4's flagged rows are
    -inf / -1."""
    metric = VectorMetric.L2
    args, exact = _k4_case(32 + n_q, n_q, metric, clustered)
    o = sq8_select(*args, k, metric)
    p = sq8_select_plain(*args, k, metric)
    flag = _k4_check(o, p, exact, k)
    assert not flag.any() if clustered else flag.all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [37, 100, 256])
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_sq8_select_other_widths(cuda_device, d, metric):
    """K4's other scoring paths: D % 4 != 0 (the CTA loads each block
    itself), D % 32 != 0 (a last TMA box part past D) and D = 256 (a block
    scored in slices of 32 rows)."""
    args, exact = _k4_case(33, 64, metric, True, d=d)
    o = sq8_select(*args, 100, metric)
    flag = _k4_check(o, sq8_select_plain(*args, 100, metric), exact, 100)
    assert not flag.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 64, 130])
def test_cuda_sq8_select_mass_ties_flag(cuda_device, n_q):
    """Every block holds the same rows: all block maxima tie, every block is
    admitted, and every query flags on both sides."""
    rng = np.random.default_rng(34)
    d, n = 16, 64 * 200
    block = rng.normal(size=(BLK, d)).astype(np.float32)
    base = np.tile(block, (n // BLK, 1))
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    sq = (base * base).sum(1).astype(np.float32)
    exact = 2.0 * q.astype(np.float64) @ base.T.astype(np.float64) - sq
    bm = np.repeat(exact.reshape(n_q, -1, BLK).max(2), 1, axis=1)
    args = _t(bm.astype(np.float32), np.zeros(n_q, np.float32), q, base, sq,
              device=cuda_device)
    o = sq8_select(*args, 100, VectorMetric.L2)
    p = sq8_select_plain(*args, 100, VectorMetric.L2)
    assert _k4_check(o, p, exact, 100).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 100, 124])
@pytest.mark.parametrize("n_q", [1, 64, 130])
def test_cuda_sq8_select_fewer_than_k_pass(cuda_device, n_q, k):
    """eps = 0 on a tie-heavy set (blocks in identical pairs) whose block
    maxima lie above every exact score, as a grid's rounding can lift them:
    no row reaches tau, fewer than k pass. K4 orders the admitted rows by
    their exact scores whatever tau is, so its top k still equals the plain
    version's."""
    rng = np.random.default_rng(35)
    d, n = 32, 64 * 300
    half = rng.normal(size=(n // 2, d)).astype(np.float32)
    base = np.concatenate([half.reshape(-1, BLK, d)] * 2, axis=1).reshape(
        n, d)
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    sq = (base * base).sum(1).astype(np.float32)
    exact = 2.0 * q.astype(np.float64) @ base.T.astype(np.float64) - sq
    lift = float(exact.max() - exact.min()) + 1.0
    bm = exact.reshape(n_q, -1, BLK).max(2) + lift
    args = _t(bm.astype(np.float32), np.zeros(n_q, np.float32), q, base, sq,
              device=cuda_device)
    o = sq8_select(*args, k, VectorMetric.L2)
    p = sq8_select_plain(*args, k, VectorMetric.L2)
    flag = _k4_check(o, p, exact, k)
    assert not flag.any()


class _ExactL2:
    """exact[b, r]: the L2 score 2 q_b . b_r - sq_eff_r in float64, from
    the card's tensors, one row at a time (the whole table would not fit
    the host)."""

    def __init__(self, q, base, sq):
        self.q, self.base, self.sq = q, base, sq

    def __getitem__(self, br):
        b, r = br
        return float(2.0 * (self.q[b].double() @ self.base[r].double())
                     - self.sq[r].double())


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [64, 130])
def test_cuda_sq8_select_large_index(cuda_device, n_q):
    """A large index: 6,000,000 rows x 768 (18.4 GB of fp32 base, 93,750
    blocks), rows of one norm so that the queries' best blocks hardly
    overlap. Each query admits its k + 4 best blocks (eps 0, bmax the block
    maxima of the fp32 scores): over 6,000 blocks are listed, so a scoring
    CTA has more items than one staged chunk of metadata. K4 runs and
    equals its plain version."""
    n, d, k = 6_000_000, 768, 100
    gen = torch.Generator(device=cuda_device).manual_seed(36)
    base = torch.randn(n, d, generator=gen, device=cuda_device)
    base *= (d ** 0.5) / base.norm(dim=1, keepdim=True)
    q = torch.randn(n_q, d, generator=gen, device=cuda_device)
    sq = (base * base).sum(dim=1)
    bm = (2.0 * (q @ base.T) - sq).view(n_q, -1, BLK).amax(dim=2)
    args = (bm, torch.zeros(n_q, device=cuda_device), q, base, sq)
    o = sq8_select(*args, k, VectorMetric.L2)
    p = sq8_select_plain(*args, k, VectorMetric.L2)
    assert not _k4_check(o, p, _ExactL2(q, base, sq), k).any()


@pytest.mark.cuda
def test_cuda_sq8_select_splits_many_queries(cuda_device, monkeypatch):
    """More than SELECT_MAX_Q queries run SELECT_MAX_Q at a time, a K4
    launch each, with the result of one launch over all of them."""
    args, _ = _k4_case(37, 130, VectorMetric.L2, True)
    whole = sq8_select(*args, 100, VectorMetric.L2)
    monkeypatch.setattr(select_mod, "SELECT_MAX_Q", 64)
    before = select_mod.sq8_select_launches.value
    parts = sq8_select(*args, 100, VectorMetric.L2)
    assert select_mod.sq8_select_launches.value - before == 3
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))
