"""reindexer_tpu_torch's full-text engine vs reindexer_tpu's, on the CPU.

The same documents and queries, made with numpy from a seed, go through
the JAX package and the port. The JAX full-text device code is plain jitted
XLA (no Pallas kernel), so the reference runs as its own tests run it.
Tolerances, with their reasons:
  - the scorer functions and the dense scorer's core: ids equal, near-ties
    at the cut compared as sets; scores within rtol 1e-5 (fp32 sums in
    another order);
  - each route through FtSelector, pinned in both packages: ranks (the
    0-255 scale) within 1e-4, except the reference's dense route, whose
    packed download rounds ranks to whole bytes (held to its own 0.5; the
    port does not copy it, ROADMAP C);
  - the holders built from one state: arrays equal;
  - the public API (the cases of tests/test_fulltext.py, each run on both
    packages): equal ids, ranks within 1e-4.
The `cuda` tests run the engine on the card against the engine on the CPU
and skip without one; the JAX package is imported lazily, so they run
where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ft.py
"""
import functools
import math
import types

import numpy as np
import pytest
import torch

import reindexer_tpu_torch as port
from reindexer_tpu_torch.convert import ft_state_from_reference
from reindexer_tpu_torch.ft import device_dense as port_dd
from reindexer_tpu_torch.ft import scorer as port_scorer
from reindexer_tpu_torch.ft import selector as port_sel
from reindexer_tpu_torch.ft.config import FtFastConfig
from reindexer_tpu_torch.ft.dataholder import FtDataHolder
from reindexer_tpu_torch.ft.dsl import parse_ft_dsl
from reindexer_tpu_torch.ft.selector import FtSelector

# this file runs beside timing-sensitive tests when the suite is spread over
# processes: a small intra-op pool keeps torch from taking every core
torch.set_num_threads(2)

RTOL = 1e-5
RANK_ATOL = 1e-4
PACKED_ATOL = 0.5
CPU = torch.device("cpu")


@functools.cache
def _ref():
    """The JAX package's full-text modules, imported here rather than at
    module level so that the `cuda` tests of this file run where JAX is
    absent."""
    import jax.numpy as jnp
    import reindexer_tpu
    from reindexer_tpu.ft import config, dataholder, device_dense, scorer
    from reindexer_tpu.ft import selector
    from reindexer_tpu.index.text import FullTextIndex
    return types.SimpleNamespace(jnp=jnp, pkg=reindexer_tpu, cfg=config,
                                 holder=dataholder, dd=device_dense,
                                 scorer=scorer, sel=selector,
                                 Text=FullTextIndex)


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_topk(ref_s, ref_i, s, i, rtol=RTOL, atol=0.0):
    """Row by row: as many results, scores within rtol, ids equal except
    near-ties at the cut (the last kept score), compared as sets."""
    ref_s, ref_i, s, i = (np.atleast_2d(n(a)) for a in (ref_s, ref_i, s, i))
    for row in range(ref_i.shape[0]):
        keep_r, keep = ref_i[row] >= 0, i[row] >= 0
        assert keep.sum() == keep_r.sum(), row
        if not keep_r.any():
            continue
        np.testing.assert_allclose(s[row][keep], ref_s[row][keep_r],
                                   rtol=rtol, atol=atol)
        kth = ref_s[row][keep_r][-1]
        score = dict(zip(ref_i[row][keep_r].tolist(),
                         ref_s[row][keep_r].tolist()))
        score.update(zip(i[row][keep].tolist(), s[row][keep].tolist()))
        for x in set(ref_i[row][keep_r].tolist()) ^ set(i[row][keep].tolist()):
            assert abs(score[x] - kth) <= rtol * abs(kth) + atol, (row, x)


def assert_same_result(ref_res, res, atol=RANK_ATOL):
    """Two FtSelectResults: equal ids (near-ties at the cut as sets), ranks
    within atol on the 0-255 scale."""
    assert_same_topk(ref_res.ranks, ref_res.ids, res.ranks, res.ids,
                     rtol=0.0, atol=atol)


# --- corpus ----------------------------------------------------------------

VOCAB_N = 40


def zipf_docs(n_docs=1500, seed=3, doc_len=12, fields=1):
    """(row, [text per field]) pairs: zipf(1.4) words over a 40-word
    vocabulary; with two fields, a 3-word title and the body."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(VOCAB_N)]
    z = np.minimum(rng.zipf(1.4, size=(n_docs, doc_len)) - 1, VOCAB_N - 1)
    words = [[vocab[j] for j in row] for row in z]
    if fields == 1:
        return [(i, [" ".join(w)]) for i, w in enumerate(words)]
    return [(i, [" ".join(w[:3]), " ".join(w[3:])])
            for i, w in enumerate(words)]


def _cfgs(**kw):
    """The same FtFastConfig in both packages."""
    out = []
    for cls in (_ref().cfg.FtFastConfig, FtFastConfig):
        cfg = cls()
        for k, v in kw.items():
            if k == "bm25_type":
                cfg.bm25.bm25_type = v
            else:
                setattr(cfg, k, v)
        out.append(cfg)
    return out


def make_pair(docs=None, fields=("text",), **kw):
    """(reference selector, port selector) over the same documents."""
    docs = zipf_docs(fields=len(fields)) if docs is None else docs
    rcfg, pcfg = _cfgs(**kw)
    cap = max(r for r, _ in docs) + 1
    rh = _ref().holder.FtDataHolder(rcfg, list(fields))
    rh.build(docs, cap)
    ph = FtDataHolder(pcfg, list(fields), CPU)
    ph.build(docs, cap)
    return _ref().sel.FtSelector(rh, rcfg), FtSelector(ph, pcfg)


CONFIGS = [(0.5, 1.1, "rx"), (0.0, 1.0, "classic"), (0.7, 1.3, "word_count")]
QUERIES = ["w0 w1", "w3 -w4", "+w5 +w6", "w7 w8 w9", "=w10", "w0 w0",
           "w1* ~w2", "w2 w2"]


# --- 1. the scorer functions against their JAX functions -------------------

GPAD, T_PAD = 1 << 12, 4   # one shape for every query: one JAX compile


def scorer_inputs(sel, dsl, gpad=GPAD, t_count=T_PAD):
    """The device inputs of one query (numpy), as the selector builds them
    (the gather arrays by the reference's host builder), padded to gpad
    postings and t_count terms."""
    q = parse_ft_dsl(dsl)
    prep = _ref().sel.FtSelector._gather_arrays(sel._prepare(q))
    h = sel.holder
    assert len(prep["g_idx"]) <= gpad and len(prep["terms"]) <= t_count

    def pad(a, size, fill=0):
        out = np.full(size, fill, dtype=a.dtype)
        out[: len(a)] = a
        return out

    return types.SimpleNamespace(
        gather=[pad(prep[k], gpad) for k in ("g_idx", "g_term", "g_w",
                                            "g_idf")],
        terms=[pad(prep["term_boost"], t_count, 1),
               pad(prep["term_lenb"], t_count, 1),
               pad(prep["must"], t_count, False),
               pad(prep["notm"], t_count, False)],
        fp=list(sel._field_params(q)), t_count=t_count,
        n_pos=int((~prep["notm"]).sum()),
        cap=h.device_arrays()["cap"], n_terms=len(prep["terms"]))


def post_args(holder):
    d = holder.device_arrays()
    return [d[k] for k in ("post_doc", "post_field", "post_tf",
                           "post_minpos", "doc_words")]


@functools.cache
def _jitted(name):
    """The reference's scorer function, jitted as its callers jit it
    (sum_ranks_sorted runs inside score_and_merge_sorted's jit there)."""
    import jax
    fn = getattr(_ref().scorer, name)
    if name != "sum_ranks_sorted":
        return fn
    return jax.jit(fn, static_argnames=(
        "t_count", "cap", "bm25_type", "use_proximity", "use_fullmatch"))


def call_both(name, rsel, psel, inp, extra_r=(), extra_p=(), static=(),
              **kw):
    """The scorer function `name` of each package on the same inputs."""
    R = _ref()
    jnp = R.jnp
    h = psel.holder
    dev = h.device_arrays()
    rdev = rsel.holder.device_arrays()
    cfg = psel.cfg
    ja = [jnp.asarray(a) for a in inp.gather]
    ta = [torch.from_numpy(a) for a in inp.gather]
    jf = [jnp.asarray(a) for a in inp.fp]
    tf = [torch.from_numpy(a) for a in inp.fp]
    jt = [jnp.asarray(a) for a in inp.terms]
    tt = [torch.from_numpy(a) for a in inp.terms]
    common = (cfg.bm25.k1, cfg.bm25.b, h.avg_doc_len)
    kwr = dict(kw, field_words=rdev["field_words"])
    kwp = dict(kw, field_words=dev["field_words"])
    want = _jitted(name)(
        *ja, *post_args(rsel.holder), *jf, *jt, *extra_r, *common,
        *static, **kwr)
    got = getattr(port_scorer, name)(
        *ta, *post_args(h), *tf, *tt, *extra_p, *common, *static,
        **kwp)
    return want, got


@pytest.fixture(scope="module")
def pairs():
    return {c: make_pair(distance_weight=c[0], full_match_boost=c[1],
                         bm25_type=c[2]) for c in CONFIGS}


@pytest.mark.parametrize("conf, name", [
    (c, f) for f in ("score_and_merge", "score_and_merge_sorted")
    for c in CONFIGS] + [(CONFIGS[0], "sum_ranks_sorted")],
    ids=lambda x: x if isinstance(x, str) else f"{x[0]}-{x[1]}-{x[2]}")
def test_single_query_scorers_match_reference(pairs, conf, name):
    rsel, psel = pairs[conf]
    for dsl in QUERIES:
        inp = scorer_inputs(psel, dsl)
        merge_k = 64
        static = (inp.t_count, inp.cap) + (
            (merge_k,) if name != "sum_ranks_sorted" else ()) + (conf[2],)
        kw = dict(dist_w=conf[0], dist_b=1.0, use_proximity=conf[0] > 0,
                  n_terms=inp.n_pos, fm_boost=conf[1],
                  use_fullmatch=conf[1] != 1.0)
        want, got = call_both(name, rsel, psel, inp, static=static, **kw)
        if name == "sum_ranks_sorted":
            # doc-run leaders: the same docs with the same scores
            ws, wd = n(want[0]), n(want[1])
            gs, gd = n(got[0]), n(got[1])
            lead_w, lead_g = np.isfinite(ws), np.isfinite(gs)
            assert sorted(wd[lead_w].tolist()) == sorted(gd[lead_g].tolist())
            np.testing.assert_allclose(gs[lead_g][np.argsort(gd[lead_g])],
                                       ws[lead_w][np.argsort(wd[lead_w])],
                                       rtol=RTOL)
        else:
            assert_same_topk(*want, *got)


def _stack(inps, key):
    G = max(len(i.gather[0]) for i in inps)
    T = max(i.t_count for i in inps)
    out = []
    for col in range(4):
        rows = [getattr(i, key)[col] for i in inps]
        size = G if key == "gather" else T
        fill = 1 if (key == "terms" and col < 2) else 0
        a = np.full((len(rows), size), fill, dtype=rows[0].dtype)
        for r, row in enumerate(rows):
            a[r, : len(row)] = row
        out.append(a)
    return out, T


@pytest.mark.parametrize("conf", CONFIGS[:2],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_batch_sorted_scorer_matches_reference(pairs, conf):
    """score_and_merge_batch_sorted: every query of a batch at once."""
    rsel, psel = pairs[conf]
    inps = [scorer_inputs(psel, d) for d in QUERIES]
    gather, T = _stack(inps, "gather")
    terms, _ = _stack(inps, "terms")
    n_pos = np.asarray([i.n_pos or -1 for i in inps], np.int32)
    R = _ref()
    jnp = R.jnp
    h, rh = psel.holder, rsel.holder
    cfg = psel.cfg
    common = (cfg.bm25.k1, cfg.bm25.b, h.avg_doc_len, T, inps[0].cap, 48,
              conf[2])
    kw = dict(dist_w=conf[0], dist_b=1.0, use_proximity=conf[0] > 0,
              fm_boost=conf[1], use_fullmatch=conf[1] != 1.0)
    want = R.scorer.score_and_merge_batch_sorted(
        *map(jnp.asarray, gather), *post_args(rh),
        *map(jnp.asarray, inps[0].fp), *map(jnp.asarray, terms), *common,
        field_words=rh.device_arrays()["field_words"],
        n_terms=jnp.asarray(n_pos), **kw)
    got = port_scorer.score_and_merge_batch_sorted(
        *map(torch.from_numpy, gather), *post_args(h),
        *map(torch.from_numpy, inps[0].fp), *map(torch.from_numpy, terms),
        *common, field_words=h.device_arrays()["field_words"],
        n_terms=torch.from_numpy(n_pos), **kw)
    assert_same_topk(*want, *got)


@pytest.mark.parametrize("conf", CONFIGS[:2],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_batch_accumulator_scorer_matches_reference(pairs, conf):
    """score_and_merge_batch: the dense [n_q * t_count, cap] accumulator,
    the queries in disjoint term-id ranges."""
    rsel, psel = pairs[conf]
    R = _ref()
    jnp = R.jnp
    inps = [scorer_inputs(psel, d) for d in QUERIES[:4]]
    t_count = max(i.t_count for i in inps)
    n_q = len(inps)
    parts = [[], [], [], []]
    terms = [np.ones(n_q * t_count, np.float32),
             np.ones(n_q * t_count, np.float32),
             np.zeros(n_q * t_count, bool), np.zeros(n_q * t_count, bool)]
    for j, i in enumerate(inps):
        for c in range(4):
            a = i.gather[c]
            parts[c].append(a + j * t_count if c == 1 else a)
            terms[c][j * t_count: j * t_count + i.t_count] = i.terms[c]
    gather = [np.concatenate(p) for p in parts]
    n_pos = np.asarray([i.n_pos or -1 for i in inps], np.int32)
    h, rh, cfg = psel.holder, rsel.holder, psel.cfg
    common = (cfg.bm25.k1, cfg.bm25.b, h.avg_doc_len, n_q, t_count,
              inps[0].cap, 32, conf[2])
    kw = dict(dist_w=conf[0], dist_b=1.0, use_proximity=conf[0] > 0,
              fm_boost=conf[1], use_fullmatch=conf[1] != 1.0)
    want = R.scorer.score_and_merge_batch(
        *map(jnp.asarray, gather), *post_args(rh),
        *map(jnp.asarray, inps[0].fp), *map(jnp.asarray, terms), *common,
        field_words=rh.device_arrays()["field_words"],
        n_terms=jnp.asarray(n_pos), **kw)
    got = port_scorer.score_and_merge_batch(
        *map(torch.from_numpy, gather), *post_args(h),
        *map(torch.from_numpy, inps[0].fp), *map(torch.from_numpy, terms),
        *common, field_words=h.device_arrays()["field_words"],
        n_terms=torch.from_numpy(n_pos), **kw)
    assert_same_topk(*want, *got)


@pytest.mark.parametrize("ratio", [0.5, 0.0])
def test_fielded_scorer_matches_reference(ratio):
    rsel, psel = make_pair(fields=("title", "body"))
    R = _ref()
    for dsl in ("@+title,+body w0 w1", "@+title,body w2 -w3", "@+title w4"):
        inp = scorer_inputs(psel, dsl)
        mask = np.zeros(len(inp.fp[0]), bool)
        mask[:2] = [True, "+body" in dsl]
        want, got = call_both(
            "score_and_merge_fielded", rsel, psel, inp,
            extra_r=(R.jnp.asarray(mask),), extra_p=(torch.from_numpy(mask),),
            static=(inp.t_count, len(inp.fp[0]), inp.cap, 40, "rx", ratio),
            dist_w=0.5, dist_b=1.0, use_proximity=inp.n_terms > 1,
            n_terms=inp.n_pos, fm_boost=1.1, use_fullmatch=inp.n_pos > 0)
        assert_same_topk(*want, *got)


def test_segmented_scans_match_reference():
    """The three scans on random runs: _pair_scan and _doc_scan at each
    run's last element (where the sorted path reads them), _seg_last_valid
    everywhere."""
    R = _ref()
    jnp = R.jnp
    rng = np.random.default_rng(5)
    n_el = 600
    starts = rng.random(n_el) < 0.3
    starts[0] = True
    ends = np.r_[starts[1:], True]
    sr = rng.random(n_el).astype(np.float32)
    mp = rng.integers(0, 50, n_el).astype(np.float32)
    valid = rng.random(n_el) < 0.4
    ints = rng.integers(0, 2, (2, n_el)).astype(np.int32)
    import jax
    pair_scan, doc_scan = (jax.jit(R.scorer._pair_scan),
                           jax.jit(R.scorer._doc_scan))
    last_valid = jax.jit(R.scorer._seg_last_valid, static_argnums=3)
    w = pair_scan(jnp.asarray(sr), jnp.asarray(mp), jnp.asarray(starts))
    g = port_scorer._pair_scan(torch.from_numpy(sr), torch.from_numpy(mp),
                               torch.from_numpy(starts))
    for a, b in zip(w, g):
        np.testing.assert_array_equal(n(b)[ends], n(a)[ends])
    w = doc_scan(jnp.asarray(sr), jnp.asarray(valid),
                           jnp.asarray(ints[0]), jnp.asarray(ints[1]),
                           jnp.asarray(starts))
    g = port_scorer._doc_scan(torch.from_numpy(sr), torch.from_numpy(valid),
                              torch.from_numpy(ints[0]),
                              torch.from_numpy(ints[1]),
                              torch.from_numpy(starts))
    np.testing.assert_allclose(n(g[0])[ends], n(w[0])[ends], rtol=RTOL)
    for a, b in zip(w[1:], g[1:]):
        np.testing.assert_array_equal(n(b)[ends], n(a)[ends])
    w = last_valid(jnp.asarray(mp), jnp.asarray(valid),
                                 jnp.asarray(starts), 1e9)
    g = port_scorer._seg_last_valid(torch.from_numpy(mp),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(starts), 1e9)
    for a, b in zip(w, g):
        np.testing.assert_array_equal(n(b), n(a))


def test_device_gather_equals_host_gather_arrays():
    """The gather arrays the port expands on the device from the posting
    runs equal the reference's host-built ones, row by row, zero past each
    query's G and in the rows past the queries."""
    _, psel = make_pair()
    preps = [psel._prepare(parse_ft_dsl(q))
             for q in ("w0 w1", "w1* ~w2", "w3 -w4", "=w10")]
    gpad = 1 << 12
    got = psel._device_gather(preps, gpad, n_rows=8)
    assert [tuple(a.shape) for a in got] == [(8, gpad)] * 4
    assert [a.dtype for a in got] == [torch.int32, torch.int32,
                                      torch.float32, torch.float32]
    for row, prep in enumerate(preps):
        R = _ref().sel.FtSelector._gather_arrays(dict(prep))
        for a, key in zip(got, ("g_idx", "g_term", "g_w", "g_idf")):
            want = np.zeros(gpad, dtype=n(a).dtype)
            want[: prep["G"]] = R[key]
            np.testing.assert_array_equal(n(a)[row], want, err_msg=key)
    assert not any(n(a)[len(preps):].any() for a in got)


def test_sorted_scorer_two_key_branch_matches_one_key():
    """A cap too large for the packed int32 (doc, term) key takes the two
    stable sorts; both branches give the same answer."""
    _, psel = make_pair()
    inp = scorer_inputs(psel, "w0 w1 -w2")
    h, cfg = psel.holder, psel.cfg
    args = [torch.from_numpy(a) for a in inp.gather] + post_args(h) \
        + [torch.from_numpy(a) for a in inp.fp + inp.terms]
    kw = dict(use_proximity=True, dist_w=0.5, field_words=None,
              use_fullmatch=False)
    common = (cfg.bm25.k1, cfg.bm25.b, h.avg_doc_len, inp.t_count)
    small = port_scorer.score_and_merge_sorted(*args, *common, inp.cap, 32,
                                               "rx", **kw)
    # a cap of 2^30 moves the padding key only; no doc reaches it
    big = port_scorer.score_and_merge_sorted(*args, *common, 1 << 30, 32,
                                             "rx", **kw)
    np.testing.assert_array_equal(n(big[1]), n(small[1]))
    np.testing.assert_array_equal(n(big[0]), n(small[0]))


# --- 2. the dense scorer's core --------------------------------------------

@pytest.fixture
def dense_env(monkeypatch):
    """The dense route for any gather, in both packages."""
    for mod in (_ref().dd, port_dd):
        monkeypatch.setattr(mod, "DEVICE_MIN", 1)
        monkeypatch.setattr(mod, "DEVICE_MIN_SINGLE", 1)
        monkeypatch.setattr(mod, "DENSE_MIN_COUNT", 1)
        monkeypatch.setattr(mod, "DENSE_WORDS", 64)
    yield


DENSE_QUERIES = ["w0 w1", "+w0 +w2", "w1 -w0", "w0 w1 w2", "=w0 =w3",
                 "w2 w2", "w0"]


@pytest.mark.parametrize("merge_limit", [20000, 16])
@pytest.mark.parametrize("dist_w, fm", [(0.5, 1.1), (0.0, 1.0)])
def test_dense_score_core_matches_reference(dense_env, dist_w, fm,
                                            merge_limit):
    """_score_core on the same resident matrices and packed batch: the
    lossless sort (merge_limit 20000 >= cap) and the per-segment prune
    (merge_limit 16), with the overflow flags."""
    rsel, psel = make_pair(distance_weight=dist_w, full_match_boost=fm,
                           merge_limit=merge_limit)
    rd, pd = rsel._device_dense(), psel._device_dense()
    assert rd.ensure_built() and pd.ensure_built()
    np.testing.assert_array_equal(pd.S.numpy(), np.asarray(rd.S))
    np.testing.assert_array_equal(pd.M.numpy(), np.asarray(rd.M))
    packs = []
    for dsl in DENSE_QUERIES:
        pack = pd.pack_query(psel._prepare(parse_ft_dsl(dsl)))
        assert pack is not None, dsl
        packs.append(pack)
    mk = min(merge_limit, pd.cap)
    want = rd.score_batch(packs, mk, dist_w > 0, fm != 1.0)
    got = pd.score_batch(packs, mk, dist_w > 0, fm != 1.0)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert_same_topk(np.where(want[1] >= 0, want[0], -np.inf), want[1],
                     np.where(got[1] >= 0, got[0], -np.inf), got[1])


# --- 3. each route through FtSelector --------------------------------------

def no_dense(monkeypatch):
    """The port's dense route for no gather."""
    monkeypatch.setattr(port_dd, "DEVICE_MIN", 1 << 40)
    monkeypatch.setattr(port_dd, "DEVICE_MIN_SINGLE", 1 << 40)


def pin(monkeypatch, route):
    """Pin both packages' selectors to one route."""
    R = _ref()
    if route in ("dense", "dense_batch"):
        for mod in (R.dd, port_dd):
            monkeypatch.setattr(mod, "DEVICE_MIN", 1)
            monkeypatch.setattr(mod, "DEVICE_MIN_SINGLE", 1)
            monkeypatch.setattr(mod, "DENSE_MIN_COUNT", 1)
        return
    monkeypatch.setenv("RX_FT_DEVICE_DENSE", "0")
    no_dense(monkeypatch)
    if route in ("sorted", "sorted_batch", "fielded"):
        monkeypatch.setattr(R.sel.FtSelector, "HOST_SCORE_MAX", -1)
        monkeypatch.setattr(FtSelector, "HOST_SCORE_MAX", -1)


def counts():
    return {k: getattr(port_sel, k).value for k in (
        "host_merges", "sorted_scores", "dense_scores", "fielded_scores",
        "dense_overflows", "native_fallbacks")}


ROUTE_QUERIES = ["w0 w1", "+w0 +w2", "w1 -w0", "w0 w1 w2", "w2 w2", "w0",
                 "w3 w30", '"w0 w1"', "w1*", "zzz"]
# the reference's sorted routes compile for every gather size and term
# count: they run these queries of one gather bucket
REF_SORTED = ["w0 w1", "w1 -w0", '"w0 w1"']
ROUTES = {   # route -> (counter the port must move, ref tolerance, ref queries)
    "host": ("host_merges", RANK_ATOL, ROUTE_QUERIES),
    "sorted": ("sorted_scores", RANK_ATOL, REF_SORTED),
    "dense": ("dense_scores", PACKED_ATOL, ROUTE_QUERIES),
    "dense_batch": ("dense_scores", PACKED_ATOL, ROUTE_QUERIES),
    "sorted_batch": ("sorted_scores", RANK_ATOL, REF_SORTED),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_reference_and_host(monkeypatch, route):
    """Each route in both packages, and the port's route against the port's
    host merge: ranks within 1e-4 (the reference's dense route within its
    own 0.5, its packed download rounding ranks to bytes)."""
    counter, ref_tol, ref_queries = ROUTES[route]
    rsel, psel = make_pair()
    _, host = make_pair()
    want_host = [host.process(q) for q in ROUTE_QUERIES]
    pin(monkeypatch, route)
    for c in (getattr(port_sel, k) for k in counts()):
        c.reset()
    if route.endswith("batch"):
        want = rsel.process_batch(ref_queries)
        got = psel.process_batch(ROUTE_QUERIES)
    else:
        want = [rsel.process(q) for q in ref_queries]
        got = [psel.process(q) for q in ROUTE_QUERIES]
    assert getattr(port_sel, counter).value > 0, counts()
    by_query = dict(zip(ROUTE_QUERIES, got))
    for q, w in zip(ref_queries, want):
        assert_same_result(w, by_query[q], atol=ref_tol)
        assert by_query[q].matched_words == w.matched_words, q
    for g, hst in zip(got, want_host):
        assert_same_result(hst, g)


def test_fielded_route_matches_reference(monkeypatch):
    rsel, psel = make_pair(fields=("title", "body"),
                           sum_ranks_by_fields_ratio=0.5)
    pin(monkeypatch, "fielded")
    port_sel.fielded_scores.reset()
    for q in ("@+title,+body w0", "@+title,+body w1 w2", "@+title w3 -w0"):
        assert_same_result(rsel.process(q), psel.process(q))
    assert port_sel.fielded_scores.value == 3


def test_frequent_single_stays_on_its_cache(monkeypatch):
    """A single-term query whose top-k the host materializes (G >=
    SINGLE_CACHE_MIN, whichever of its merges computes it) answers from
    that cache whatever HOST_SCORE_MAX is; a 2-term query of the same size
    takes the device. Both answer as the reference does (its cache follows
    its DENSE_MIN)."""
    rsel, psel = make_pair()
    monkeypatch.setattr(FtSelector, "SINGLE_CACHE_MIN", 16)
    monkeypatch.setattr(_ref().sel.FtSelector, "DENSE_MIN", 16)
    monkeypatch.setattr(FtSelector, "HOST_SCORE_MAX", 64)
    no_dense(monkeypatch)
    for c in (getattr(port_sel, k) for k in counts()):
        c.reset()
    assert psel.warm_frequent_singles(4) == 4
    assert len(psel.holder._single_top_cache) == 4
    got = [psel.process("w0") for _ in range(2)]
    assert counts()["host_merges"] == 6 and counts()["sorted_scores"] == 0
    pair = psel.process("w0 w1")
    assert counts()["sorted_scores"] == 1
    assert_same_result(rsel.process("w0"), got[1])
    assert_same_result(rsel.process("w0 w1"), pair)


def test_overflow_falls_back_exact(monkeypatch):
    """Every candidate tied and merge_limit 8: the prune cannot certify
    the cut, the query goes to the host merge (counted), and the answer is
    the exact top 8 by doc."""
    docs = [(i, ["w0 w1 w0"]) for i in range(1500)]
    rsel, psel = make_pair(docs, merge_limit=8)
    pin(monkeypatch, "dense")
    port_sel.dense_overflows.reset()
    port_sel.host_merges.reset()
    got = psel.process("w0 w1")
    assert got.ids.tolist() == list(range(8))
    assert port_sel.dense_overflows.value == 1
    assert port_sel.host_merges.value == 1
    assert_same_result(rsel.process("w0 w1"), got)
    batch = psel.process_batch(["w0 w1", "w1 w0"])
    assert [r.ids.tolist() for r in batch] == [list(range(8))] * 2
    assert port_sel.dense_overflows.value == 3


@pytest.mark.reference_divergence
def test_reference_dense_route_rounds_ranks_to_bytes(monkeypatch):
    """The reference's dense route downloads ranks packed into whole bytes
    (device_dense.py:195-203 of the JAX package), so its answer depends on
    its route; the port downloads the scores and normalizes on the host, as
    every route does, and agrees with its host merge to fp32 rounding."""
    rsel, psel = make_pair()
    _, host = make_pair()
    queries = ["w0 w1", "w0 w1 w2", "w1 -w0"]
    want = [host.process(q) for q in queries]
    pin(monkeypatch, "dense")
    ref_ranks = np.concatenate([rsel.process(q).ranks for q in queries])
    assert np.array_equal(ref_ranks, np.round(ref_ranks))
    assert not np.array_equal(np.concatenate([w.ranks for w in want]),
                              np.round(np.concatenate([w.ranks
                                                       for w in want])))
    for q, w in zip(queries, want):
        g = psel.process(q)
        assert_same_result(w, g)
        np.testing.assert_allclose(g.ranks, w.ranks, rtol=RTOL)


@pytest.mark.reference_divergence
def test_reference_dense_route_fails_on_two_fields(monkeypatch):
    """With two text fields and a full-match boost, the reference's dense
    scorer broadcasts the searched-field mask over the batch axis
    (`searched[:, None, None]`, device_dense.py:135-137 of the JAX package)
    and fails; the port's mask runs over the field axis, and its dense
    route agrees with its host merge."""
    rsel, psel = make_pair(fields=("title", "body"))
    _, host = make_pair(fields=("title", "body"))
    queries = ["w0 w1", "w0 w1 w2"]
    want = [host.process(q) for q in queries]
    pin(monkeypatch, "dense")
    port_sel.dense_scores.reset()
    with pytest.raises(TypeError):
        rsel.process(queries[0])
    for w, g in zip(want, [psel.process(q) for q in queries]):
        assert_same_result(w, g)
    assert port_sel.dense_scores.value == len(queries)


def test_native_fallback_is_counted(monkeypatch):
    """Without the C++ lane, the queries the host merge would answer take
    the device sorted path, each counted as a native fallback, and answer
    as the host merge does."""
    from reindexer_tpu_torch.ft import dataholder
    _, psel = make_pair()
    queries = ["w0 w1", "w3 -w4", '"w0 w1"']
    want = [psel.process(q) for q in queries]
    no_dense(monkeypatch)
    monkeypatch.setattr(dataholder, "_NATIVE", None)
    monkeypatch.setattr(dataholder, "_NATIVE_TRIED", True)
    for c in (getattr(port_sel, k) for k in counts()):
        c.reset()
    got = [psel.process(q) for q in queries] + psel.process_batch(queries)
    assert counts() == {"host_merges": 0, "sorted_scores": 6,
                        "dense_scores": 0, "fielded_scores": 0,
                        "dense_overflows": 0, "native_fallbacks": 6}
    for w, g in zip(want * 2, got):
        assert_same_result(w, g)


def test_warm_frequent_singles_skips_only_parse_errors(monkeypatch):
    """The commit-time warm skips a head word that does not parse as a
    query term, and lets every other error through."""
    _, psel = make_pair()
    monkeypatch.setattr(FtSelector, "SINGLE_CACHE_MIN", 16)

    def fails(err):
        def process(dsl, normalize=True):
            raise err
        return process

    monkeypatch.setattr(psel, "process",
                        fails(port.QueryError("unterminated phrase")))
    assert psel.warm_frequent_singles(4) == 0
    monkeypatch.setattr(psel, "process", fails(RuntimeError("device lost")))
    with pytest.raises(RuntimeError, match="device lost"):
        psel.warm_frequent_singles(4)


# --- 4. the holders, and state carried across ------------------------------

HOLDER_ARRAYS = ("words", "word_start", "post_doc", "post_field", "post_tf",
                 "post_minpos", "pos_flat", "doc_words", "field_words")


def test_holders_from_one_state_are_equal():
    """A reference FullTextIndex.state_dict() carried into the port builds
    the same holder arrays, and the same device mirrors."""
    R = _ref()
    ridx = R.Text(R.pkg.IndexDef("ft", "text", "string",
                                 json_paths=("title", "body")))
    for row, (title, body) in zipf_docs(400, seed=9, fields=2):
        ridx.upsert(row * 2, [title, body])
    ridx.commit()
    state = ft_state_from_reference(ridx.state_dict())
    from reindexer_tpu_torch.index.text import FullTextIndex
    pidx = FullTextIndex(port.IndexDef("ft", "text", "string",
                                       json_paths=("title", "body")), CPU)
    pidx.load_state_dict(state)
    pidx.commit()
    for name in HOLDER_ARRAYS:
        a, b = getattr(ridx.holder, name), getattr(pidx.holder, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    rd, pd = ridx.holder.device_arrays(), pidx.holder.device_arrays()
    assert rd["cap"] == pd["cap"]
    for k in rd:
        if k != "cap":
            assert str(np.asarray(rd[k]).dtype) == str(pd[k].numpy().dtype)
            np.testing.assert_array_equal(pd[k].numpy(), np.asarray(rd[k]))
    res = [ix.select_key(ix_ct, ("w0 w1",)) for ix, ix_ct in (
        (ridx, R.pkg.CondType.EQ), (pidx, port.CondType.EQ))]
    assert_same_topk(res[0].ranks, res[0].ids, res[1].ranks, res[1].ids,
                     rtol=0.0, atol=RANK_ATOL)


def test_ft_state_from_reference_checks_its_input():
    with pytest.raises(port.ParamsError):
        ft_state_from_reference({"docs": {1: "not a list"},
                                 "rows_capacity": 2})
    with pytest.raises(port.ParamsError):
        ft_state_from_reference({"docs": {5: ["a"]}, "rows_capacity": 2})
    st = ft_state_from_reference({"docs": {"3": ("a b", None)},
                                  "rows_capacity": 4})
    assert st == {"docs": {3: ["a b", ""]}, "rows_capacity": 4}


def test_device_mirrors_are_32_bit():
    """torch.from_numpy keeps 64-bit arrays 64-bit where jnp.asarray
    narrows them: every mirror is cast to the reference's 32-bit dtype."""
    _, psel = make_pair()
    d = psel.holder.device_arrays()
    assert {k: str(v.dtype) for k, v in d.items() if k != "cap"} == {
        "post_doc": "torch.int32", "post_field": "torch.int32",
        "post_tf": "torch.float32", "post_minpos": "torch.int32",
        "doc_words": "torch.float32", "field_words": "torch.int32"}
    assert d["cap"] == 2048 and d["post_doc"].shape[0] & (
        d["post_doc"].shape[0] - 1) == 0


# --- 5. the copied host text layers ----------------------------------------

@pytest.mark.parametrize("dsl", [
    "+quick -lazy termina* *nator black~ =exact word^2",
    '@title^2,+body "quick fox"~3 dog', "中文搜索 test 42"])
def test_dsl_parses_alike(dsl):
    from reindexer_tpu.ft.dsl import parse_ft_dsl as ref_parse
    assert repr(parse_ft_dsl(dsl)) == repr(ref_parse(dsl))


def test_stemmers_typos_and_numbers_alike():
    from reindexer_tpu.ft import numtotext as rn, stemmer as rs, typos as rt
    from reindexer_tpu_torch.ft import numtotext as pn, stemmer as ps
    from reindexer_tpu_torch.ft import typos as pt
    words = ["running", "generously", "connection", "кошками", "бежали",
             "terminator", "quickly"]
    for lang in ("en", "ru"):
        assert ([ps.get_stemmer(lang)(w) for w in words]
                == [rs.get_stemmer(lang)(w) for w in words])
    for w in words:
        assert pt.deletions(w, 2) == rt.deletions(w, 2)
    for num in ("0", "13", "125", "2001", "1000000", "007"):
        assert pn.num_to_text(num) == rn.num_to_text(num)


# --- 6. the route constants are the fit of an H100 table -------------------

# The `[ft routes]` tables of four runs of chip_smoke.py on an NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit (the runs PERF.md names: run 2, the
# final run, run 3 and run 4 of the port's full-text slice): 2-term
# queries of two words of about equal frequency on BASELINE config #4's
# corpus (bench_ft1m: 1,000,000 docs x 30 zipf(1.3) words over 100,000);
# per row G (gathered
# postings), then ms a query on the host clock: the host merge (at the
# constants of the time), the device sorted path, the dense route at batch
# 1, 8 and 36 (a query's share), the host's heap merge and its dense merge
# (None: the route does not take the query: its words are not resident, or
# G < docs / 4).
ROUTE_TABLES = {
    "run 2": [
        (16308, 1.9478, 3.834, None, None, None, 1.9225, None),
        (32685, 3.0593, 3.6599, None, None, None, 2.8546, None),
        (65176, 4.4255, 3.9036, None, None, None, 5.8993, None),
        (128457, 7.6546, 4.5482, 2.3173, 0.8456, 1.2522, 8.1461, None),
        (250201, 22.1917, 5.8069, 3.293, 0.7005, 0.8397, 12.5984, 20.1808),
        (500343, 30.4129, 6.9604, 3.0425, 0.8782, 1.1451, 28.7199, 31.657),
        (987977, 43.543, 10.703, 3.458, 0.8122, 0.9566, 63.481, 44.5335),
        (1961612, 26.6538, 17.1301, 2.632, 0.6709, 0.7861, 72.9803,
         27.4995),
    ],
    "final": [
        (16308, 2.2787, 4.9226, None, None, None, 2.4318, None),
        (32685, 4.0389, 5.2987, None, None, None, 3.5811, None),
        (65176, 5.331, 5.9843, None, None, None, 5.4878, None),
        (128457, 8.0478, 5.8422, 2.7776, 0.6777, 0.8171, 8.092, None),
        (250201, 15.3161, 8.3855, 4.7262, 1.0654, 1.0856, 18.8204, 27.7521),
        (500343, 27.4465, 7.0187, 3.0929, 0.7421, 0.8672, 26.4675, 30.5411),
        (987977, 40.5377, 11.437, 2.8234, 0.6738, 0.7955, 53.6409, 39.7429),
        (1961612, 30.6211, 18.1989, 3.1389, 0.6968, 0.7995, 65.3127,
         29.5625),
    ],
    "run 3": [
        (16308, 2.3869, 4.6329, None, None, None, 2.0074, None),
        (32685, 3.4317, 5.2473, None, None, None, 3.104, None),
        (65176, 6.2815, 4.6777, None, None, None, 4.8641, None),
        (128457, 9.4957, 6.1577, 3.6396, 0.7369, 1.0388, 10.0447, None),
        (250201, 13.2191, 4.8854, 2.4671, 0.6705, 0.9954, 12.0602, 22.83),
        (500343, 25.2866, 6.9345, 2.5736, 0.7832, 0.833, 26.2001, 27.1902),
        (987977, 34.0366, 10.0854, 2.5813, 0.6454, 0.781, 46.9317, 38.9814),
        (1961612, 29.9009, 18.546, 2.8615, 0.6956, 0.7949, 64.7557,
         27.341),
    ],
    "run 4": [
        (16308, 3.0272, 6.4674, None, None, None, 2.7492, None),
        (32685, 3.3625, 5.8314, None, None, None, 3.9986, None),
        (65176, 4.8148, 4.77, None, None, None, 6.3997, None),
        (128457, 9.9209, 4.7371, 3.1052, 0.6975, 0.8553, 7.84, None),
        (250201, 14.6176, 5.4509, 2.6435, 0.6807, 0.8717, 11.9408, 19.3379),
        (500343, 30.5196, 8.0447, 3.5867, 0.8241, 0.9635, 31.2966, 31.0926),
        (987977, 38.8925, 10.5394, 3.0855, 0.7727, 0.7985, 47.7222, 36.2372),
        (1961612, 25.3703, 17.5854, 2.6387, 0.6704, 0.8209, 57.2043,
         24.3991),
    ],
}


def route_points(tables):
    """The tables' rows grouped by G: one tuple of rows (one a run) a G."""
    points = list(zip(*(sorted(t) for t in tables)))
    assert all(len({r[0] for r in p}) == 1 for p in points)
    return points


def fit_routes(tables):
    """(HOST_SCORE_MAX, DEVICE_MIN_SINGLE, DEVICE_MIN, DENSE_MIN) fitted to
    the runs' tables (rows: G, host, sorted, dense at batch 1, 8 and 36,
    host heap merge, host dense merge; ms a query, None where the route
    does not take the query). A crossover is the power of two at or below
    the G of the first row from which on the second route is faster at
    every larger row in every run (2^40: never), so it moves only where all
    runs agree. DENSE_MIN comes first: the host's time of a row is then
    its heap merge below DENSE_MIN and its dense merge from there on (where
    the dense merge applies); the device routes are held against that. No
    table gives the reference's values."""
    if not tables:
        return 1 << 23, 1 << 21, 1 << 19, 1 << 17
    points = route_points(tables)

    def crossover(slow, fast):
        for i, point in enumerate(points):
            if all(slow(r) is not None and fast(r) is not None
                   and fast(r) < slow(r) for p in points[i:] for r in p):
                return 1 << int(math.floor(math.log2(point[0][0])))
        return 1 << 40

    dense_min = crossover(lambda r: r[6], lambda r: r[7])

    def host(r):
        return r[7] if r[0] >= dense_min and r[7] is not None else r[6]

    return (crossover(host, lambda r: r[2]), crossover(host, lambda r: r[3]),
            crossover(host, lambda r: r[5]), dense_min)


def test_route_constants_are_the_fit_of_the_h100_table():
    """The four crossovers are the fit of ROUTE_TABLES' runs; at every G no
    route that every run finds faster than the one the constants pick is
    left unpicked (the host's own pick between its two merges included).
    The runs' single fits differ at HOST_SCORE_MAX (the 65k row is faster
    on the device in three runs of four) and at DENSE_MIN (the 500k row's
    two host merges are within 1% in the last run)."""
    tables = list(ROUTE_TABLES.values())
    fit = fit_routes(tables)
    assert fit == (1 << 16, 1 << 16, 1 << 16, 1 << 19)
    assert [fit_routes([t]) for t in tables] == [
        (1 << 15, 1 << 16, 1 << 16, 1 << 19),
        (1 << 16, 1 << 16, 1 << 16, 1 << 19),
        (1 << 15, 1 << 16, 1 << 16, 1 << 19),
        (1 << 15, 1 << 16, 1 << 16, 1 << 18)]
    for point in route_points(tables):
        G = point[0][0]

        def host(r):
            return r[7] if G >= fit[3] and r[7] is not None else r[6]

        def pick(r):
            return (r[3] if r[3] is not None and G >= fit[1]
                    else r[2] if G > fit[0] else host(r))

        for alt in (host, lambda r: r[2], lambda r: r[3]):
            assert not all(alt(r) is not None and alt(r) < pick(r)
                           for r in point), G
    assert fit == (FtSelector.HOST_SCORE_MAX, port_dd.DEVICE_MIN_SINGLE,
                   port_dd.DEVICE_MIN, FtSelector.DENSE_MIN)


# --- 7. the mesh seams ------------------------------------------------------

def test_mesh_seams_raise_naming_a12():
    """The mesh seams are ported (tests/test_torch_mesh_engines.py): a
    `text` index takes a mesh, a selector on a 4-shard CPU mesh scores
    doc-sharded (sharded_scores) with the reference's single-device ranks,
    and its dense head doc-shards its matrices."""
    from reindexer_tpu_torch.index.text import FullTextIndex
    from reindexer_tpu_torch.parallel.context import MeshContext
    ctx = MeshContext(["cpu"] * 4)
    idx = FullTextIndex(port.IndexDef("ft", "text", "string"), CPU)
    idx.attach_mesh(ctx)
    assert idx._mesh_ctx is ctx
    rsel, psel = make_pair()
    msel = FtSelector(psel.holder, psel.cfg, mesh_ctx=ctx)
    pack = msel._mesh_pack()
    assert len(pack["post_doc"]) == 4
    port_sel.sharded_scores.reset()
    for dsl in ("w0 w1", "w3 -w4", "+w5 +w6"):
        want, got = rsel.process(dsl), msel.process(dsl)
        assert set(got.ids.tolist()) == set(want.ids.tolist()), dsl
        np.testing.assert_allclose(np.sort(got.ranks), np.sort(want.ranks),
                                   rtol=1e-4, atol=1e-4)
    assert port_sel.sharded_scores.value > 0
    dd = msel._device_dense()
    if dd.ensure_built():
        assert dd._mesh is ctx and len(dd.S) == 4


# --- 8. the public API: the cases of tests/test_fulltext.py ----------------

DOCS = [
    {"id": 1, "title": "quick brown fox",
     "body": "the quick brown fox jumps over the lazy dog"},
    {"id": 2, "title": "lazy dogs",
     "body": "dogs are lazy animals sleeping all day"},
    {"id": 3, "title": "terminator", "body": "terminator movie with arnold"},
    {"id": 4, "title": "terminal velocity",
     "body": "airport terminal and velocity physics"},
    {"id": 5, "title": "running fast",
     "body": "he runs faster than anyone running races"},
    {"id": 6, "title": "black cat", "body": "a black cat crossed the street"},
]


def make_db(pkg, ft_config=None, docs=DOCS):
    db = (pkg.Reindexer(device="cpu") if pkg is port else pkg.Reindexer())
    db.open_namespace("docs", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("ft", "text", "string", json_paths=("title", "body"),
                     ft_config=ft_config or {})])
    for d in docs:
        db.upsert("docs", d)
    return db


class Run:
    """One case on one package: `sel(dsl)` selects and records (ids,
    ranks, docs); cases assert the reference's expectations on each
    package, and the test then requires both records equal."""

    def __init__(self, pkg, tmp_path):
        self.pkg, self.tmp_path, self.seen = pkg, tmp_path, []
        self.Q = pkg.Query

    def db(self, ft_config=None, docs=DOCS):
        return make_db(self.pkg, ft_config, docs)

    def record(self, res):
        self.seen.append(([d["id"] for d in res.docs()],
                          [it.rank for it in res], res.docs()))
        return [d["id"] for d in res.docs()]

    def sel(self, db, dsl, fn=None, where=None):
        q = self.Q("docs").match("ft", dsl)
        if fn:
            q = q.functions(fn)
        if where:
            q = q.where(*where)
        return self.record(db.select(q))

    def index(self, db):
        return db.get_namespace("docs").get_index("ft")


def case_basic_and_boolean(r):
    db = r.db()
    assert r.sel(db, "fox") == [1]
    assert set(r.sel(db, "lazy dog")) >= {1, 2}
    assert r.sel(db, "+lazy -fox") == [2]
    assert r.sel(db, "lazy", where=("id", ">", 1)) == [2]


def case_prefix_suffix(r):
    db = r.db()
    assert set(r.sel(db, "termina*")) == {3, 4}
    assert r.sel(r.db({"full_match_boost": 1.0}),
                 "terminator termina*")[0] == 3
    assert r.sel(db, "terminator termina*")[0] == 4
    assert set(r.sel(db, "*nator")) == {3}


def case_typos_stems_exact(r):
    db = r.db()
    assert 6 in r.sel(db, "blck~") and 6 in r.sel(db, "block~")
    assert 5 in r.sel(db, "runs")
    assert r.sel(db, "=run") == []


def case_phrase(r):
    db = r.db()
    assert r.sel(db, '"quick brown fox"') == [1]
    assert r.sel(db, '"fox brown"') == []
    assert r.sel(db, '"quick fox"~2') == [1]
    assert r.sel(db, '"quick fox"') == []


def case_fields(r):
    db = r.db()
    assert r.sel(db, "@title dogs") == [2]
    assert r.sel(db, "@body sleeping") == [2]
    assert 4 in r.sel(db, "@title^0.1,body^10 terminal")


def case_stop_words_and_synonyms(r):
    assert r.sel(r.db({"stop_words": ["the", "a"]}), "the") == []
    syn = r.db({"synonyms": [{"tokens": ["fast"], "alternatives": ["quick"]}]})
    assert set(r.sel(syn, "fast")) >= {1, 5}
    assert r.sel(r.db(), "the") == [] and r.sel(r.db(), "over") == []
    custom = r.db({"stop_words": ["fox"]})
    assert r.sel(custom, "fox") == [] and 1 in r.sel(custom, "the")


def case_russian_stop_words(r):
    db = r.db(docs=[{"id": 70, "title": "кошка",
                     "body": "и вот кошка на крыше"}])
    assert r.sel(db, "и") == [] and r.sel(db, "вот") == []
    assert 70 in r.sel(db, "кошка")


def case_highlight_snippet(r):
    db = r.db()
    r.sel(db, "fox", fn="body = highlight(<b>,</b>)")
    assert "<b>fox</b>" in r.seen[-1][2][0]["body"]
    r.sel(db, "jumps", fn="body = snippet(<b>,</b>,5,5)")
    body = r.seen[-1][2][0]["body"]
    assert "<b>jumps</b>" in body and len(body) < len(DOCS[0]["body"]) + 10
    # areas: a title match does not highlight the body
    db.upsert("docs", {"id": 50, "title": "orange juice",
                       "body": "the word orange also appears here"})
    r.sel(db, "@title orange", fn="body = highlight(<b>,</b>)")
    assert "<b>" not in [d for d in r.seen[-1][2] if d["id"] == 50][0]["body"]
    r.sel(db, "@title orange", fn="title = highlight(<b>,</b>)")
    assert [d for d in r.seen[-1][2]
            if d["id"] == 50][0]["title"] == "<b>orange</b> juice"
    # the stored document stays as it was
    r.record(db.select(r.Q("docs").where("id", "=", 50)))
    assert r.seen[-1][2][0]["body"] == "the word orange also appears here"


def case_highlight_positional_stop_words(r):
    db = r.db({"stop_words": ["the", "a"]},
              docs=[{"id": 51, "title": "the quick brown dog",
                     "body": "a dog sat on the mat"}])
    r.sel(db, "dog mat", fn="body = highlight([,])")
    assert r.seen[-1][2][0]["body"] == "a [dog] sat on the [mat]"


def case_update_invalidates(r):
    db = r.db()
    assert r.sel(db, "zebra") == []
    db.upsert("docs", {"id": 7, "title": "zebra stripes", "body": "zebra"})
    assert r.sel(db, "zebra") == [7]
    db.delete("docs", {"id": 7})
    assert r.sel(db, "zebra") == []


def case_bm25_rx_oracle(r):
    texts = ["apple apple apple banana cherry date egg fig grape kiwi",
             "apple banana", "apple apple banana cherry date egg",
             "banana cherry date egg fig grape"]
    db = r.db(docs=[{"id": i, "title": t, "body": ""}
                    for i, t in enumerate(texts)])
    k1, b, lens = 2.0, 0.75, [10, 2, 6, 6]
    avg = np.mean(lens)
    idf = max(0.2, math.log((4 - 3 + 1) / 3) / math.log(1 + 4))
    scores = {i: idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * lens[i] / avg))
              for i, tf in {0: 3, 1: 1, 2: 2}.items()}
    assert r.sel(db, "apple") == sorted(scores, key=lambda i: -scores[i])


def case_incremental_steps(r):
    db = r.db()
    assert r.sel(db, "arnold") == [3]
    idx = r.index(db)
    db.upsert("docs", {"id": 20, "title": "arnold returns",
                       "body": "newest arnold sequel"})
    db.upsert("docs", {"id": 3, "title": "renamed movie",
                       "body": "no more robots"})
    assert not idx._full_dirty
    got = r.sel(db, "arnold")
    assert 20 in got and 3 not in got
    db.delete("docs", {"id": 20})
    assert r.sel(db, "arnold") == []
    idx._full_dirty = True
    assert r.sel(db, "arnold") == []


def case_incremental_multi_step_and_rebuild(r):
    db = r.db({"max_step_size": 2, "max_rebuild_steps": 3})
    r.sel(db, "fox")
    idx = r.index(db)
    sizes = []
    for i in range(30, 37):
        db.upsert("docs", {"id": i, "title": "extra", "body": "zzz"})
        if i in (31, 32, 34, 35, 36):
            assert len(r.sel(db, "zzz")) == i - 29
            sizes.append(len(idx._steps))
    assert sizes == [1, 2, 2, 3, 0] and not idx._full_dirty


def case_incremental_recommit_last_step(r):
    db = r.db({"max_step_size": 10})
    r.sel(db, "fox")
    idx = r.index(db)
    for i in range(30, 34):
        db.upsert("docs", {"id": i, "title": "inc", "body": "qqq"})
        assert len(r.sel(db, "qqq")) == i - 29 and len(idx._steps) == 1
    db.upsert("docs", {"id": 1, "title": "qqq now", "body": "changed"})
    r.sel(db, "qqq")
    db.upsert("docs", {"id": 31, "title": "gone", "body": "different"})
    got = r.sel(db, "qqq")
    assert 31 not in got and 1 in got
    db.delete("docs", {"id": 1})
    got = sorted(r.sel(db, "qqq"))
    idx._full_dirty = True
    assert got == sorted(r.sel(db, "qqq"))


def case_sum_ranks_by_fields_ratio(r):
    db = r.db({"sum_ranks_by_fields_ratio": 0.5},
              docs=[{"id": 1, "title": "alpha", "body": "alpha"},
                    {"id": 2, "title": "alpha", "body": "nothing"}])
    assert r.sel(db, "@+title,+body alpha")[0] == 1
    ranks = dict(zip(*r.seen[-1][:2]))
    assert ranks[1] > ranks[2]
    assert set(r.sel(db, "@title,body alpha")) == {1, 2}


def case_ft_batch(r):
    db = r.db()
    for res in db.ft_batch("docs", "ft", ["fox", "terminator", "+lazy -fox",
                                          '"quick brown fox"', "zzzz"]):
        r.record(res)
    assert [s[0] for s in r.seen] == [[1], [3, 4], [2], [1], []]
    r.sel(db, "fox")
    db.upsert("docs", {"id": 50, "title": "newfox arrival", "body": "fox"})
    assert 50 in r.record(db.ft_batch("docs", "ft", ["fox"])[0])


def case_cjk(r):
    db = r.db(docs=[{"id": 1, "title": "中文搜索引擎", "body": "支持中文"},
                    {"id": 2, "title": "日本語テスト", "body": "漢字"}])
    assert r.sel(db, "搜索") == [1] and r.sel(db, '"中文搜索"') == [1]
    assert r.sel(db, "漢字") == [2] and r.sel(db, '"搜索中文"') == []


def case_mmseg(r):
    lex = r.tmp_path / "lex.txt"
    lex.write_text("魑魅\t50\n", encoding="utf-8")
    db = r.db({"splitter": "mmseg_cn", "splitter_dict_path": str(lex)},
              docs=[{"id": 1, "title": "全文搜索引擎", "body": "研究生命起源"},
                    {"id": 2, "title": "机器学习模型", "body": "魑魅魍魉"}])
    assert r.sel(db, "生命") == [1] and r.sel(db, "搜索引擎") == [1]
    assert r.sel(db, "机器学习") == [2] and r.sel(db, "魑魅") == [2]


def case_merge_limit_and_min_rank(r):
    db = r.db({"merge_limit": 3},
              docs=[{"id": i, "title": f"common term {i}", "body": "common"}
                    for i in range(10)])
    assert 0 < len(r.sel(db, "common")) <= 3
    db = r.db({"min_rank": 200}, docs=[
        {"id": 1, "title": "target target target",
         "body": "target target target target"},
        {"id": 2, "title": "mostly other words here",
         "body": "target appears once in a longer body " * 3}])
    assert 1 in r.sel(db, "target")
    assert all(x >= 200 for x in r.seen[-1][1])


def case_full_match_boost(r):
    db = r.db(docs=[{"id": 1, "title": "quick fox", "body": "zzz yyy xxx www"},
                    {"id": 2, "title": "the quick fox jumps",
                     "body": "aaa bbb ccc"}])
    r.sel(db, "quick fox")
    ranks = dict(zip(*r.seen[-1][:2]))
    assert set(ranks) == {1, 2} and ranks[1] > ranks[2]


def case_numbers_search(r):
    off = r.db(docs=[{"id": 80, "title": "n", "body": "комната 125"}])
    assert r.sel(off, "двадцать") == []
    db = r.db({"enable_numbers_search": True},
              docs=[{"id": 81, "title": "n", "body": "комната 125"},
                    {"id": 82, "title": "n", "body": "комната 300"}])
    assert r.sel(db, "двадцать") == [81] and r.sel(db, "триста") == [82]
    assert set(r.sel(db, "сто")) == {81} and r.sel(db, "125") == [81]
    assert r.sel(db, '"комната пять"~2') == [81]


def case_sql_condition(r):
    db = r.db()
    r.record(db.select("SELECT * FROM docs WHERE ft = 'lazy dog'"))
    assert set(r.seen[-1][0]) >= {1, 2}


def case_warm_frequent_singles(r):
    rng = np.random.default_rng(7)
    words = [f"v{i}" for i in range(40)]
    rows = [{"id": 1000 + i, "title": "t",
             "body": " ".join((["hotword"] if i % 2 == 0 else [])
                              + list(rng.choice(words, size=4)))}
            for i in range(300)]
    # the port's per-word cache has its own threshold; the reference's
    # follows its DENSE_MIN
    sel_cls, attr = ((FtSelector, "SINGLE_CACHE_MIN") if r.pkg is port
                     else (_ref().sel.FtSelector, "DENSE_MIN"))
    saved = getattr(sel_cls, attr)
    setattr(sel_cls, attr, 16)
    try:
        cold = r.db({"warmup_frequent_words": 0}, docs=rows)
        warm = r.db({"warmup_frequent_words": 8}, docs=rows)
        warm.select(r.Q("docs").match("ft", "v0"))
        assert r.index(warm).holder._single_top_cache
        a = r.record(warm.select(r.Q("docs").match("ft", "hotword").limit(20)))
        b = r.record(cold.select(r.Q("docs").match("ft", "hotword").limit(20)))
        assert a == b and len(a) == 20
    finally:
        setattr(sel_cls, attr, saved)


API_CASES = {name[5:]: fn for name, fn in globals().items()
             if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(API_CASES))
def test_public_api_matches_reference(case, tmp_path):
    """A case of tests/test_fulltext.py through the public API of each
    package: the reference's expectations hold on both, and both give the
    same ids, ranks (within 1e-4) and documents."""
    runs = []
    for pkg in (_ref().pkg, port):
        r = Run(pkg, tmp_path)
        API_CASES[case](r)
        runs.append(r.seen)
    assert len(runs[0]) == len(runs[1])
    for (wi, wr, wd), (gi, gr, gd) in zip(*runs):
        assert gi == wi and gd == wd
        assert [r is None for r in gr] == [r is None for r in wr]
        np.testing.assert_allclose([r for r in gr if r is not None],
                                   [r for r in wr if r is not None],
                                   rtol=0, atol=RANK_ATOL)


@pytest.mark.parametrize("dist_w", [0.5, 0.0])
def test_term_proximity_boost_matches_reference(dist_w):
    """tests/test_fulltext.py's proximity case on both selectors: terms
    close together outrank terms far apart (equal without the boost)."""
    near = "alpha beta " + " ".join(f"f{i}" for i in range(28))
    far = "alpha " + " ".join(f"x{i}" for i in range(28)) + " beta"
    rsel, psel = make_pair([(0, [near]), (1, [far])],
                           distance_weight=dist_w)
    for sel in (rsel, psel):
        sel.cfg.default_field.position_weight = 0.0
    want, got = rsel.process("alpha beta"), psel.process("alpha beta")
    assert_same_result(want, got)
    ranks = dict(zip(got.ids.tolist(), got.ranks.tolist()))
    assert set(ranks) == {0, 1}
    assert (ranks[0] > ranks[1]) if dist_w else abs(ranks[0] - ranks[1]) < 1e-3


def test_selector_batch_matches_single_on_both():
    """tests/test_fulltext.py's batch case: process_batch equals process
    per query, in both packages, on the same documents."""
    docs = [(d["id"], [d["title"], d["body"]]) for d in DOCS]
    rsel, psel = make_pair(docs, fields=("title", "body"))
    dsls = ["fox", "+lazy -fox", "termina*", '"quick brown fox"', "zzzz"]
    for sel in (rsel, psel):
        for dsl, got in zip(dsls, sel.process_batch(dsls)):
            single = sel.process(dsl)
            assert got.ids.tolist() == single.ids.tolist(), dsl
            np.testing.assert_allclose(got.ranks, single.ranks, rtol=1e-5)
    for dsl in dsls:
        assert_same_result(rsel.process(dsl), psel.process(dsl))


# --- 9. on the card ---------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's routes run only there")


def _port_pair(device, **kw):
    cfg = FtFastConfig()
    for k, v in kw.items():
        setattr(cfg, k, v)
    h = FtDataHolder(cfg, ["text"], device)
    h.build(zipf_docs(), 1500)
    return FtSelector(h, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["sorted", "dense", "dense_batch",
                                   "sorted_batch"])
def test_cuda_routes_match_cpu(monkeypatch, route):
    """Each device route on the card against the same route on the CPU."""
    _need_cuda()
    monkeypatch.setattr(port_dd, "DEVICE_MIN", 1)
    monkeypatch.setattr(port_dd, "DEVICE_MIN_SINGLE", 1)
    monkeypatch.setattr(port_dd, "DENSE_MIN_COUNT", 1)
    if route.startswith("sorted"):
        no_dense(monkeypatch)
        monkeypatch.setattr(FtSelector, "HOST_SCORE_MAX", -1)
    cpu, gpu = _port_pair(CPU), _port_pair(torch.device("cuda"))
    if route.endswith("batch"):
        want, got = (s.process_batch(ROUTE_QUERIES) for s in (cpu, gpu))
    else:
        want = [cpu.process(q) for q in ROUTE_QUERIES]
        got = [gpu.process(q) for q in ROUTE_QUERIES]
    for w, g in zip(want, got):
        assert_same_result(w, g)
    assert gpu.holder.device_arrays()["post_doc"].is_cuda


@pytest.mark.cuda
def test_cuda_public_api_matches_cpu():
    _need_cuda()
    got = []
    for dev in ("cpu", "cuda"):
        db = port.Reindexer(device=dev)
        db.open_namespace("docs", [
            port.IndexDef("id", "hash", "int",
                          opts=port.IndexOpts(is_pk=True)),
            port.IndexDef("ft", "text", "string",
                          json_paths=("title", "body"))])
        for d in DOCS:
            db.upsert("docs", d)
        res = db.select(port.Query("docs").match("ft", "lazy dog"))
        got.append(([d["id"] for d in res.docs()], res.ranks()))
    assert got[0][0] == got[1][0]
    np.testing.assert_allclose(got[1][1], got[0][1], atol=RANK_ATOL)
