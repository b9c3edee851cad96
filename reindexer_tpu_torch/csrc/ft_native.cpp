// Native FT build pipeline: tokenizer + vocab + token-stream arrays (the
// port's copy of reindexer_tpu/csrc/ft_native.cpp; built with g++ by
// reindexer_tpu_torch/csrc/__init__.py).
//
// Native-footprint equivalent of the reference's C++ text splitter and
// words-map builder (cpp_src/core/ft/ft_fast/splitter.cc,
// dataprocessor.cc buildWordsMap — the multithreaded host build, P2 in
// SURVEY.md §2.4). The Python layer (ft/dataholder.py) uses this module
// when available and falls back to the pure-Python tokenizer otherwise;
// token semantics are *identical* by construction because classification
// and lowercasing use CPython's own Unicode tables (Py_UNICODE_ISALNUM /
// Py_UNICODE_TOLOWER == str.lower()/[^\W_] behavior).
//
// Exposed function:
//   build_tokens(docs, extra_symbols) ->
//       (vocab: list[str],
//        token_ids: bytes int64[n], doc_ids: bytes int32[n],
//        field_ids: bytes int32[n], positions: bytes int32[n])
// where docs is a sequence of (row:int, field:int, text:str) triples and
// positions are per-(row, field) token ordinals. Stop-word filtering happens
// vectorized on the Python side (vocab-id mask), keeping this kernel pure.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct TokenSink {
    std::unordered_map<std::string, int64_t> vocab;
    std::vector<std::string> words;
    std::vector<int64_t> token_ids;
    std::vector<int32_t> doc_ids;
    std::vector<int32_t> field_ids;
    std::vector<int32_t> positions;

    int64_t intern(const std::string& w) {
        auto it = vocab.find(w);
        if (it != vocab.end()) return it->second;
        int64_t id = (int64_t)words.size();
        vocab.emplace(w, id);
        words.push_back(w);
        return id;
    }
};

inline void append_utf8(std::string& out, Py_UCS4 cp) {
    if (cp < 0x80) {
        out += (char)cp;
    } else if (cp < 0x800) {
        out += (char)(0xC0 | (cp >> 6));
        out += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
        out += (char)(0xE0 | (cp >> 12));
        out += (char)(0x80 | ((cp >> 6) & 0x3F));
        out += (char)(0x80 | (cp & 0x3F));
    } else {
        out += (char)(0xF0 | (cp >> 18));
        out += (char)(0x80 | ((cp >> 12) & 0x3F));
        out += (char)(0x80 | ((cp >> 6) & 0x3F));
        out += (char)(0x80 | (cp & 0x3F));
    }
}

// word rule mirrors ft/tokenizer.py: starts/ends with alnum (not '_'),
// interior may additionally contain '_' and the extra symbols
inline bool is_word_core(Py_UCS4 c) {
    return c != '_' && Py_UNICODE_ISALNUM(c);
}

// CJK ideographs/kana tokenize as single characters (ft/tokenizer.py
// _split_cjk — the unigram analog of the reference's MMSeg splitter)
inline bool is_cjk(Py_UCS4 c) {
    return (c >= 0x3040 && c <= 0x30FF)     // kana
        || (c >= 0x3400 && c <= 0x4DBF)     // CJK ext A
        || (c >= 0x4E00 && c <= 0x9FFF)     // CJK unified
        || (c >= 0xF900 && c <= 0xFAFF);    // CJK compat
}

void tokenize_into(PyObject* text, const std::vector<Py_UCS4>& extra,
                   int32_t row, int32_t field, TokenSink& sink) {
    Py_ssize_t len = PyUnicode_GET_LENGTH(text);
    int kind = PyUnicode_KIND(text);
    const void* data = PyUnicode_DATA(text);
    int32_t pos = 0;
    std::string word;
    Py_ssize_t i = 0;
    while (i < len) {
        Py_UCS4 c = Py_UNICODE_TOLOWER(PyUnicode_READ(kind, data, i));
        if (!is_word_core(c)) { i++; continue; }
        if (is_cjk(c)) {
            // CJK char is its own token
            word.clear();
            append_utf8(word, c);
            i++;
            int64_t wid = sink.intern(word);
            sink.token_ids.push_back(wid);
            sink.doc_ids.push_back(row);
            sink.field_ids.push_back(field);
            sink.positions.push_back(pos++);
            continue;
        }
        // word start
        word.clear();
        Py_ssize_t last_core_end = i + 1;
        append_utf8(word, c);
        size_t last_core_bytes = word.size();
        i++;
        while (i < len) {
            Py_UCS4 d = Py_UNICODE_TOLOWER(PyUnicode_READ(kind, data, i));
            if (is_cjk(d)) break;   // CJK boundary closes the word
            bool core = is_word_core(d);
            bool interior = core || d == '_';
            if (!interior) {
                bool is_extra = false;
                for (Py_UCS4 e : extra) {
                    if (d == e) { is_extra = true; break; }
                }
                interior = is_extra;
            }
            if (!interior) break;
            append_utf8(word, d);
            i++;
            if (core) {
                last_core_end = i;
                last_core_bytes = word.size();
            }
        }
        // trim trailing non-core chars (regex requires core at word end)
        word.resize(last_core_bytes);
        i = last_core_end;
        int64_t wid = sink.intern(word);
        sink.token_ids.push_back(wid);
        sink.doc_ids.push_back(row);
        sink.field_ids.push_back(field);
        sink.positions.push_back(pos++);
    }
}

PyObject* vec_to_bytes(const void* data, size_t nbytes) {
    return PyBytes_FromStringAndSize((const char*)data, (Py_ssize_t)nbytes);
}

PyObject* build_tokens(PyObject* /*self*/, PyObject* args) {
    PyObject* docs;
    PyObject* extra_obj;
    if (!PyArg_ParseTuple(args, "OO", &docs, &extra_obj)) return nullptr;

    std::vector<Py_UCS4> extra;
    if (PyUnicode_Check(extra_obj)) {
        Py_ssize_t elen = PyUnicode_GET_LENGTH(extra_obj);
        int ekind = PyUnicode_KIND(extra_obj);
        const void* edata = PyUnicode_DATA(extra_obj);
        for (Py_ssize_t j = 0; j < elen; j++)
            extra.push_back(PyUnicode_READ(ekind, edata, j));
    }

    TokenSink sink;
    PyObject* seq = PySequence_Fast(docs, "docs must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t k = 0; k < n; k++) {
        PyObject* triple = PySequence_Fast_GET_ITEM(seq, k);
        PyObject* row_o = PyTuple_GetItem(triple, 0);
        PyObject* field_o = PyTuple_GetItem(triple, 1);
        PyObject* text_o = PyTuple_GetItem(triple, 2);
        if (!row_o || !field_o || !text_o) { Py_DECREF(seq); return nullptr; }
        long row = PyLong_AsLong(row_o);
        long field = PyLong_AsLong(field_o);
        if (PyErr_Occurred()) { Py_DECREF(seq); return nullptr; }
        if (!PyUnicode_Check(text_o)) continue;
        tokenize_into(text_o, extra, (int32_t)row, (int32_t)field, sink);
    }
    Py_DECREF(seq);

    PyObject* vocab = PyList_New((Py_ssize_t)sink.words.size());
    if (!vocab) return nullptr;
    for (size_t j = 0; j < sink.words.size(); j++) {
        PyObject* w = PyUnicode_DecodeUTF8(
            sink.words[j].data(), (Py_ssize_t)sink.words[j].size(), "replace");
        if (!w) { Py_DECREF(vocab); return nullptr; }
        PyList_SET_ITEM(vocab, (Py_ssize_t)j, w);
    }
    PyObject* out = Py_BuildValue(
        "(NNNNN)", vocab,
        vec_to_bytes(sink.token_ids.data(), sink.token_ids.size() * 8),
        vec_to_bytes(sink.doc_ids.data(), sink.doc_ids.size() * 4),
        vec_to_bytes(sink.field_ids.data(), sink.field_ids.size() * 4),
        vec_to_bytes(sink.positions.data(), sink.positions.size() * 4));
    return out;
}

// ---------------------------------------------------------------------------
// Batched phrase verification over the postings CSR (native equivalent of
// the reference PhraseMerger walk, cpp_src/core/ft/ft_fast/phrasemerger*.h).
// For each candidate doc: per phrase slot, merge the slot's word-variant
// position lists per field; a doc passes when some field has a position
// chain p1 < p2 < ... with 1 <= p(i+1) - p(i) <= dist.
// ---------------------------------------------------------------------------

struct PhraseBuf {
    Py_buffer view{};
    bool ok = false;
    ~PhraseBuf() {
        if (ok) PyBuffer_Release(&view);
    }
    bool get(PyObject* obj) {
        if (PyObject_GetBuffer(obj, &view, PyBUF_CONTIG_RO) != 0) return false;
        ok = true;
        return true;
    }
};

PyObject* verify_phrases(PyObject* /*self*/, PyObject* args) {
    PyObject *post_doc_o, *post_field_o, *pos_start_o, *pos_flat_o, *docs_o,
        *slots_o;
    long dist = 1;
    if (!PyArg_ParseTuple(args, "OOOOOOl", &post_doc_o, &post_field_o,
                          &pos_start_o, &pos_flat_o, &docs_o, &slots_o,
                          &dist)) {
        return nullptr;
    }
    PhraseBuf post_doc_b, post_field_b, pos_start_b, pos_flat_b, docs_b;
    if (!post_doc_b.get(post_doc_o) || !post_field_b.get(post_field_o) ||
        !pos_start_b.get(pos_start_o) || !pos_flat_b.get(pos_flat_o) ||
        !docs_b.get(docs_o)) {
        return nullptr;
    }
    const int32_t* post_doc = (const int32_t*)post_doc_b.view.buf;
    const int32_t* post_field = (const int32_t*)post_field_b.view.buf;
    const int64_t* pos_start = (const int64_t*)pos_start_b.view.buf;
    const int32_t* pos_flat = (const int32_t*)pos_flat_b.view.buf;
    const int32_t* docs = (const int32_t*)docs_b.view.buf;
    Py_ssize_t n_docs = docs_b.view.len / 4;

    // slots: list (per phrase slot) of int64 [n_var, 2] posting ranges
    Py_ssize_t n_slots = PySequence_Size(slots_o);
    std::vector<std::vector<std::pair<int64_t, int64_t>>> slots(n_slots);
    for (Py_ssize_t i = 0; i < n_slots; i++) {
        PyObject* arr = PySequence_GetItem(slots_o, i);
        PhraseBuf b;
        bool got = arr && b.get(arr);
        if (got) {
            const int64_t* r = (const int64_t*)b.view.buf;
            Py_ssize_t nv = b.view.len / 16;
            for (Py_ssize_t v = 0; v < nv; v++) {
                slots[i].emplace_back(r[2 * v], r[2 * v + 1]);
            }
        }
        Py_XDECREF(arr);
        if (!got) return nullptr;
    }

    std::vector<uint8_t> out(n_docs, 0);
    // scratch: per slot, field -> sorted positions
    std::vector<std::vector<std::pair<int32_t, std::vector<int32_t>>>> per_slot(
        n_slots);
    std::vector<int32_t> cur, nxt_keep;
    for (Py_ssize_t di = 0; di < n_docs; di++) {
        int32_t d = docs[di];
        bool all_slots = true;
        for (Py_ssize_t si = 0; si < n_slots && all_slots; si++) {
            auto& fields = per_slot[si];
            fields.clear();
            for (auto& rg : slots[si]) {
                // binary search the doc inside this word's doc-sorted range
                const int32_t* lo_p = std::lower_bound(
                    post_doc + rg.first, post_doc + rg.second, d);
                const int32_t* hi_p = std::upper_bound(
                    lo_p, post_doc + rg.second, d);
                for (const int32_t* p = lo_p; p < hi_p; p++) {
                    int64_t pi = p - post_doc;
                    int32_t f = post_field[pi];
                    std::vector<int32_t>* vec = nullptr;
                    for (auto& kv : fields) {
                        if (kv.first == f) {
                            vec = &kv.second;
                            break;
                        }
                    }
                    if (!vec) {
                        fields.emplace_back(f, std::vector<int32_t>());
                        vec = &fields.back().second;
                    }
                    for (int64_t z = pos_start[pi]; z < pos_start[pi + 1];
                         z++) {
                        vec->push_back(pos_flat[z]);
                    }
                }
            }
            if (fields.empty()) all_slots = false;
            for (auto& kv : fields) {
                std::sort(kv.second.begin(), kv.second.end());
                kv.second.erase(
                    std::unique(kv.second.begin(), kv.second.end()),
                    kv.second.end());
            }
        }
        if (!all_slots) continue;
        // chain per field present in slot 0
        bool doc_ok = false;
        for (auto& kv0 : per_slot[0]) {
            int32_t f = kv0.first;
            cur = kv0.second;
            bool ok = true;
            for (Py_ssize_t si = 1; si < n_slots && ok; si++) {
                const std::vector<int32_t>* nxt = nullptr;
                for (auto& kv : per_slot[si]) {
                    if (kv.first == f) {
                        nxt = &kv.second;
                        break;
                    }
                }
                if (!nxt) {
                    ok = false;
                    break;
                }
                // keep x in nxt with some c in cur, 1 <= x - c <= dist
                nxt_keep.clear();
                size_t ci = 0;
                for (int32_t x : *nxt) {
                    while (ci < cur.size() && cur[ci] < x - (int32_t)dist) {
                        ci++;
                    }
                    if (ci < cur.size() && cur[ci] <= x - 1) {
                        nxt_keep.push_back(x);
                    }
                }
                cur = nxt_keep;
                ok = !cur.empty();
            }
            if (ok) {
                doc_ok = true;
                break;
            }
        }
        out[di] = doc_ok ? 1 : 0;
    }
    return PyBytes_FromStringAndSize((const char*)out.data(), n_docs);
}

// ---------------------------------------------------------------------------
// Host BM25 scoring + merge for small/medium gathered posting sets.
//
// Native equivalent of the reference's Merger::Merge / mergeTerm hot loop
// (cpp_src/core/ft/ft_fast/merger.h + mergerimpl.h:95-124), semantically
// identical to ft/scorer.sum_ranks_sorted (the device formulation): per
// gathered posting compute subTermRank, group by (doc, term) taking the max
// over variants (min over positions), then fold per doc: term-proximity
// attenuation, must/not masks, fullMatchBoost, docRank = sum of term maxes.
//
// The device sorted path pays a [n_q, Gmax] bitonic sort padded to the
// batch's LARGEST gather (query skew: median G ~1e2, max ~1e4 on zipf
// corpora) plus dispatch RTT; a one-core merge of <=1e5 postings runs in
// ~1 ms, so small gathers score on host and the device handles 1M-doc
// corpora (ft/selector.py chooses by gather size).
// ---------------------------------------------------------------------------

inline float pos2rank(float p) {
    if (p <= 10.f) return 1.0f - p / 100.f;
    if (p <= 100.f) return 0.9f - p / 1000.f;
    if (p <= 1000.f) return 0.8f - p / 10000.f;
    if (p <= 10000.f) return 0.7f - p / 100000.f;
    if (p <= 100000.f) return 0.6f - p / 1000000.f;
    return 0.5f;
}

struct ScoreEnt {
    int32_t doc;
    int32_t term;
    float sr;
    float mp;
};

PyObject* score_merge(PyObject* /*self*/, PyObject* args) {
    PyObject *g_idx_o, *g_term_o, *g_w_o, *g_idf_o;
    PyObject *post_doc_o, *post_field_o, *post_tf_o, *post_minpos_o;
    PyObject *doc_words_o, *fb_o, *bb_o, *bw_o, *pb_o, *pw_o;
    PyObject *term_boost_o, *term_lenb_o, *must_o, *notm_o, *field_words_o;
    double k1, b, avg_len, dist_w, dist_b, fm_boost;
    long bm25_type, use_prox, n_fields, cap, n_terms, use_fm;
    if (!PyArg_ParseTuple(
            args, "OOOOOOOOOOOOOOOOOOdddlddlOlllld",
            &g_idx_o, &g_term_o, &g_w_o, &g_idf_o, &post_doc_o, &post_field_o,
            &post_tf_o, &post_minpos_o, &doc_words_o, &fb_o, &bb_o, &bw_o,
            &pb_o, &pw_o, &term_boost_o, &term_lenb_o, &must_o, &notm_o,
            &k1, &b, &avg_len, &bm25_type, &dist_w, &dist_b, &use_prox,
            &field_words_o, &n_fields, &cap, &n_terms, &use_fm, &fm_boost)) {
        return nullptr;
    }
    PhraseBuf g_idx_b, g_term_b, g_w_b, g_idf_b, post_doc_b, post_field_b,
        post_tf_b, post_minpos_b, doc_words_b, fb_b, bb_b, bw_b, pb_b, pw_b,
        tb_b, tl_b, must_b, notm_b, fw_b;
    if (!g_idx_b.get(g_idx_o) || !g_term_b.get(g_term_o) ||
        !g_w_b.get(g_w_o) || !g_idf_b.get(g_idf_o) ||
        !post_doc_b.get(post_doc_o) || !post_field_b.get(post_field_o) ||
        !post_tf_b.get(post_tf_o) || !post_minpos_b.get(post_minpos_o) ||
        !doc_words_b.get(doc_words_o) || !fb_b.get(fb_o) || !bb_b.get(bb_o) ||
        !bw_b.get(bw_o) || !pb_b.get(pb_o) || !pw_b.get(pw_o) ||
        !tb_b.get(term_boost_o) || !tl_b.get(term_lenb_o) ||
        !must_b.get(must_o) || !notm_b.get(notm_o)) {
        return nullptr;
    }
    bool have_fw = field_words_o != Py_None;
    if (have_fw && !fw_b.get(field_words_o)) return nullptr;

    const int32_t* g_idx = (const int32_t*)g_idx_b.view.buf;
    const int32_t* g_term = (const int32_t*)g_term_b.view.buf;
    const float* g_w = (const float*)g_w_b.view.buf;
    const float* g_idf = (const float*)g_idf_b.view.buf;
    const int32_t* post_doc = (const int32_t*)post_doc_b.view.buf;
    const int32_t* post_field = (const int32_t*)post_field_b.view.buf;
    const float* post_tf = (const float*)post_tf_b.view.buf;
    const int32_t* post_minpos = (const int32_t*)post_minpos_b.view.buf;
    const float* doc_words = (const float*)doc_words_b.view.buf;
    const float* fb = (const float*)fb_b.view.buf;
    const float* bb = (const float*)bb_b.view.buf;
    const float* bw = (const float*)bw_b.view.buf;
    const float* pb = (const float*)pb_b.view.buf;
    const float* pw = (const float*)pw_b.view.buf;
    const float* term_boost = (const float*)tb_b.view.buf;
    const float* term_lenb = (const float*)tl_b.view.buf;
    const uint8_t* must = (const uint8_t*)must_b.view.buf;
    const uint8_t* notm = (const uint8_t*)notm_b.view.buf;
    const int32_t* field_words =
        have_fw ? (const int32_t*)fw_b.view.buf : nullptr;
    Py_ssize_t G = g_idx_b.view.len / 4;
    Py_ssize_t T = must_b.view.len;

    int n_must = 0;
    for (Py_ssize_t t = 0; t < T; t++) n_must += must[t] ? 1 : 0;

    std::vector<ScoreEnt> ents;
    ents.reserve(G);
    for (Py_ssize_t i = 0; i < G; i++) {
        if (g_w[i] <= 0.f) continue;              // padding
        int64_t pi = g_idx[i];
        int32_t fld = post_field[pi];
        float tf = post_tf[pi];
        float wdoc = doc_words[post_doc[pi]];
        if (wdoc < 1.f) wdoc = 1.f;
        float bm25;
        if (bm25_type == 2) {                     // word_count
            bm25 = tf;
        } else {
            float t_freq = (bm25_type == 1) ? tf / wdoc : tf;  // classic|rx
            bm25 = g_idf[i] * t_freq * (float)(k1 + 1.0) /
                   (t_freq + (float)k1 *
                                 (1.f - (float)b +
                                  (float)b * wdoc / (float)avg_len));
        }
        float bm25_norm = (1.f - bw[fld]) + bm25 * bb[fld] * bw[fld];
        float posrank =
            (1.f - pw[fld]) + pos2rank((float)post_minpos[pi]) * pb[fld] * pw[fld];
        float sr = fb[fld] * g_w[i] * bm25_norm * term_boost[g_term[i]] *
                   term_lenb[g_term[i]] * posrank;
        ents.push_back(
            {post_doc[pi], g_term[i], sr, (float)post_minpos[pi]});
    }
    std::sort(ents.begin(), ents.end(), [](const ScoreEnt& a,
                                           const ScoreEnt& b2) {
        return a.doc != b2.doc ? a.doc < b2.doc : a.term < b2.term;
    });

    std::vector<int32_t> out_docs;
    std::vector<float> out_scores;
    size_t i = 0, n = ents.size();
    while (i < n) {
        int32_t d = ents[i].doc;
        double docsum = 0.0;
        bool excl = false;
        int must_cnt = 0, pos_cnt = 0;
        float carry = 0.f;
        bool hasp = false;
        while (i < n && ents[i].doc == d) {
            int32_t t = ents[i].term;
            float smax = ents[i].sr, pmin = ents[i].mp;
            for (; i < n && ents[i].doc == d && ents[i].term == t; i++) {
                if (ents[i].sr > smax) smax = ents[i].sr;
                if (ents[i].mp < pmin) pmin = ents[i].mp;
            }
            bool present = smax > 0.f;
            if (!present) continue;
            float att = smax;
            if (use_prox && hasp) {
                float dist = pmin > carry ? pmin - carry : carry - pmin;
                if (dist < 1.f) dist = 1.f;
                att = smax * ((float)(1.0 - dist_w) +
                              (float)(dist_b * dist_w) / dist);
            }
            bool is_not = notm[t] != 0;
            if (!is_not) {
                docsum += att;
                pos_cnt++;
                carry = pmin;
                hasp = true;
            } else {
                excl = true;
            }
            if (must[t]) must_cnt++;
        }
        if (excl || must_cnt != n_must || docsum <= 0.0) continue;
        if (use_fm && have_fw && pos_cnt == (int)n_terms) {
            for (long f = 0; f < n_fields; f++) {
                if (fb[f] > 0.f && field_words[f * cap + d] == (int)n_terms) {
                    docsum *= fm_boost;
                    break;
                }
            }
        }
        out_docs.push_back(d);
        out_scores.push_back((float)docsum);
    }
    PyObject* docs_b2 = PyBytes_FromStringAndSize(
        (const char*)out_docs.data(), out_docs.size() * 4);
    PyObject* scores_b2 = PyBytes_FromStringAndSize(
        (const char*)out_scores.data(), out_scores.size() * 4);
    PyObject* tup = PyTuple_Pack(2, docs_b2, scores_b2);
    Py_XDECREF(docs_b2);
    Py_XDECREF(scores_b2);
    return tup;
}

// ---------------------------------------------------------------------------
// Presorted k-way run merge (no sort): the gathered postings are a
// concatenation of per-(term, variant-word) CSR ranges, each already sorted
// by doc (ft/dataholder.py builds postings doc-major). score_merge pays an
// O(G log G) std::sort of 16-byte structs — ~200 ms at 2e6 postings — which
// this entrypoint replaces with a binary-heap merge over the R runs keyed by
// (doc, term): O(G log R) with R ~ tens. Scoring is inlined per posting
// (per-run weight/idf/term hoisted) and the top-merge_k selection happens
// here (nth_element) instead of a full np.argsort on the Python side.
// Same reference hot loop as score_merge: mergerimpl.h:95-124 Merger::Merge.
// ---------------------------------------------------------------------------

struct RunHead {
    uint64_t key;      // (doc << 20) | term  — merge order = (doc, term)
    int32_t run;
};

PyObject* score_merge_runs(PyObject* /*self*/, PyObject* args) {
    PyObject *run_start_o, *run_len_o, *run_term_o, *run_w_o, *run_idf_o;
    PyObject *post_doc_o, *post_field_o, *post_tf_o, *post_minpos_o;
    PyObject *doc_words_o, *fb_o, *bb_o, *bw_o, *pb_o, *pw_o;
    PyObject *term_boost_o, *term_lenb_o, *must_o, *notm_o, *field_words_o;
    PyObject *pa_o = Py_None, *pb2_o = Py_None, *pr_o = Py_None;
    double k1, b, avg_len, dist_w, dist_b, fm_boost;
    long bm25_type, use_prox, n_fields, cap, n_terms, use_fm, merge_k;
    if (!PyArg_ParseTuple(
            args, "OOOOOOOOOOOOOOOOOOOdddlddlOlllldl|OOO",
            &run_start_o, &run_len_o, &run_term_o, &run_w_o, &run_idf_o,
            &post_doc_o, &post_field_o, &post_tf_o, &post_minpos_o,
            &doc_words_o, &fb_o, &bb_o, &bw_o, &pb_o, &pw_o,
            &term_boost_o, &term_lenb_o, &must_o, &notm_o,
            &k1, &b, &avg_len, &bm25_type, &dist_w, &dist_b, &use_prox,
            &field_words_o, &n_fields, &cap, &n_terms, &use_fm, &fm_boost,
            &merge_k, &pa_o, &pb2_o, &pr_o)) {
        return nullptr;
    }
    PhraseBuf rs_b, rl_b, rt_b, rw_b, ri_b, post_doc_b, post_field_b,
        post_tf_b, post_minpos_b, doc_words_b, fb_b, bb_b, bw_b, pb_b, pw_b,
        tb_b, tl_b, must_b, notm_b, fw_b, pa_b, pb2_b, pr_b;
    if (!rs_b.get(run_start_o) || !rl_b.get(run_len_o) ||
        !rt_b.get(run_term_o) || !rw_b.get(run_w_o) || !ri_b.get(run_idf_o) ||
        !post_doc_b.get(post_doc_o) || !post_field_b.get(post_field_o) ||
        !post_tf_b.get(post_tf_o) || !post_minpos_b.get(post_minpos_o) ||
        !doc_words_b.get(doc_words_o) || !fb_b.get(fb_o) || !bb_b.get(bb_o) ||
        !bw_b.get(bw_o) || !pb_b.get(pb_o) || !pw_b.get(pw_o) ||
        !tb_b.get(term_boost_o) || !tl_b.get(term_lenb_o) ||
        !must_b.get(must_o) || !notm_b.get(notm_o)) {
        return nullptr;
    }
    bool have_fw = field_words_o != Py_None;
    if (have_fw && !fw_b.get(field_words_o)) return nullptr;
    // precomputed per-posting affine score parts: sr = w*(A[p] + beta*B[p])
    // with beta in run_idf (query-independent A/B built by the selector)
    bool have_ab = pa_o != Py_None && pb2_o != Py_None;
    if (have_ab && (!pa_b.get(pa_o) || !pb2_b.get(pb2_o))) return nullptr;
    const float* PA = have_ab ? (const float*)pa_b.view.buf : nullptr;
    const float* PB = have_ab ? (const float*)pb2_b.view.buf : nullptr;
    // fully-folded per-posting rank PR = A + idf_word*B (idf is a
    // corpus statistic, so PR is query-independent): ONE load + ONE
    // multiply per posting — the merge is memory-bound on one core
    bool have_pr = pr_o != Py_None;
    if (have_pr && !pr_b.get(pr_o)) return nullptr;
    const float* PR = have_pr ? (const float*)pr_b.view.buf : nullptr;

    const int64_t* run_start = (const int64_t*)rs_b.view.buf;
    const int64_t* run_len = (const int64_t*)rl_b.view.buf;
    const int32_t* run_term = (const int32_t*)rt_b.view.buf;
    const float* run_w = (const float*)rw_b.view.buf;
    const float* run_idf = (const float*)ri_b.view.buf;
    const int32_t* post_doc = (const int32_t*)post_doc_b.view.buf;
    const int32_t* post_field = (const int32_t*)post_field_b.view.buf;
    const float* post_tf = (const float*)post_tf_b.view.buf;
    const int32_t* post_minpos = (const int32_t*)post_minpos_b.view.buf;
    const float* doc_words = (const float*)doc_words_b.view.buf;
    const float* fb = (const float*)fb_b.view.buf;
    const float* bb = (const float*)bb_b.view.buf;
    const float* bw = (const float*)bw_b.view.buf;
    const float* pb = (const float*)pb_b.view.buf;
    const float* pw = (const float*)pw_b.view.buf;
    const float* term_boost = (const float*)tb_b.view.buf;
    const float* term_lenb = (const float*)tl_b.view.buf;
    const uint8_t* must = (const uint8_t*)must_b.view.buf;
    const uint8_t* notm = (const uint8_t*)notm_b.view.buf;
    const int32_t* field_words =
        have_fw ? (const int32_t*)fw_b.view.buf : nullptr;
    Py_ssize_t R = rs_b.view.len / 8;
    Py_ssize_t T = must_b.view.len;

    int n_must = 0;
    for (Py_ssize_t t = 0; t < T; t++) n_must += must[t] ? 1 : 0;

    // per-run cursor + hoisted per-run scoring constants
    std::vector<int64_t> cur(R), end(R);
    std::vector<float> rboost(R);     // fb-independent run factor
    for (Py_ssize_t r = 0; r < R; r++) {
        cur[r] = run_start[r];
        end[r] = run_start[r] + run_len[r];
        int32_t t = run_term[r];
        rboost[r] = run_w[r] * term_boost[t] * term_lenb[t];
    }
    const float k1f = (float)k1, bf = (float)b;
    const float k1p1 = k1f + 1.0f;
    const float kb_base = k1f * (1.0f - bf);
    const float kb_scale = k1f * bf / (float)avg_len;

    // binary min-heap of run heads keyed by (doc, term)
    std::vector<RunHead> heap;
    heap.reserve(R);
    auto key_of = [&](Py_ssize_t r) -> uint64_t {
        return ((uint64_t)(uint32_t)post_doc[cur[r]] << 20) |
               (uint32_t)run_term[r];
    };
    for (Py_ssize_t r = 0; r < R; r++) {
        if (cur[r] < end[r]) heap.push_back({key_of(r), (int32_t)r});
    }
    auto sift_down = [&](size_t i) {
        size_t n2 = heap.size();
        RunHead v = heap[i];
        while (true) {
            size_t l = 2 * i + 1;
            if (l >= n2) break;
            size_t m = l;
            if (l + 1 < n2 && heap[l + 1].key < heap[l].key) m = l + 1;
            if (heap[m].key >= v.key) break;
            heap[i] = heap[m];
            i = m;
        }
        heap[i] = v;
    };
    for (size_t i = heap.size() / 2; i-- > 0;) sift_down(i);

    std::vector<int32_t> out_docs;
    std::vector<float> out_scores;
    int64_t total_g = 0;
    for (Py_ssize_t r = 0; r < R; r++) total_g += run_len[r];
    out_docs.reserve((size_t)total_g);
    out_scores.reserve((size_t)total_g);

    // doc-group state (mirrors score_merge's inner loops)
    int32_t cur_doc = -1;
    double docsum = 0.0;
    bool excl = false;
    int must_cnt = 0, pos_cnt = 0;
    float carry = 0.f;
    bool hasp = false;
    // (doc, term)-group state
    int32_t cur_term = -1;
    float smax = 0.f, pmin = 0.f;

    auto flush_term = [&]() {
        if (cur_term < 0) return;
        bool present = smax > 0.f;
        if (present) {
            float att = smax;
            if (use_prox && hasp) {
                float dist = pmin > carry ? pmin - carry : carry - pmin;
                if (dist < 1.f) dist = 1.f;
                att = smax * ((float)(1.0 - dist_w) +
                              (float)(dist_b * dist_w) / dist);
            }
            bool is_not = notm[cur_term] != 0;
            if (!is_not) {
                docsum += att;
                pos_cnt++;
                carry = pmin;
                hasp = true;
            } else {
                excl = true;
            }
            if (must[cur_term]) must_cnt++;
        }
        cur_term = -1;
    };
    auto flush_doc = [&]() {
        flush_term();
        if (cur_doc >= 0 && !excl && must_cnt == n_must && docsum > 0.0) {
            double ds = docsum;
            if (use_fm && have_fw && pos_cnt == (int)n_terms) {
                for (long f = 0; f < n_fields; f++) {
                    if (fb[f] > 0.f &&
                        field_words[f * cap + cur_doc] == (int)n_terms) {
                        ds *= fm_boost;
                        break;
                    }
                }
            }
            out_docs.push_back(cur_doc);
            out_scores.push_back((float)ds);
        }
        cur_doc = -1;
        docsum = 0.0;
        excl = false;
        must_cnt = pos_cnt = 0;
        carry = 0.f;
        hasp = false;
    };

    while (!heap.empty()) {
        RunHead h = heap[0];
        int32_t r = h.run;
        int64_t pi = cur[r];
        int32_t d = post_doc[pi];
        int32_t t = run_term[r];
        if (d != cur_doc) {
            flush_doc();
            cur_doc = d;
        } else if (t != cur_term) {
            flush_term();
        }
        // inline subTermRank (identical math to score_merge)
        int32_t fld = post_field[pi];
        float tf = post_tf[pi];
        float wdoc = doc_words[d];
        if (wdoc < 1.f) wdoc = 1.f;
        float bm25;
        if (bm25_type == 2) {
            bm25 = tf;
        } else {
            float t_freq = (bm25_type == 1) ? tf / wdoc : tf;
            bm25 = run_idf[r] * t_freq * k1p1 /
                   (t_freq + kb_base + kb_scale * wdoc);
        }
        float bm25_norm = (1.f - bw[fld]) + bm25 * bb[fld] * bw[fld];
        float mpf = (float)post_minpos[pi];
        float posrank = (1.f - pw[fld]) + pos2rank(mpf) * pb[fld] * pw[fld];
        float sr = fb[fld] * rboost[r] * bm25_norm * posrank;
        if (cur_term < 0) {
            cur_term = t;
            smax = sr;
            pmin = mpf;
        } else {
            if (sr > smax) smax = sr;
            if (mpf < pmin) pmin = mpf;
        }
        // advance the run head; replace-top + one sift
        if (++cur[r] < end[r]) {
            heap[0].key = key_of(r);
            sift_down(0);
        } else {
            heap[0] = heap.back();
            heap.pop_back();
            if (!heap.empty()) sift_down(0);
        }
    }
    flush_doc();

    // top-merge_k by (score desc, doc asc) — parity with the former
    // np.argsort(-scores, kind="stable") over docs emitted doc-ascending.
    // Packed u64 keys (inverted sortable-float score | doc) make both the
    // nth_element and the final sort branch-free single-word compares.
    size_t n_out = out_docs.size();
    std::vector<uint64_t> keys(n_out);
    for (size_t i = 0; i < n_out; i++) {
        uint32_t u;
        float s = out_scores[i];
        std::memcpy(&u, &s, 4);
        u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // sortable asc
        keys[i] = ((uint64_t)(~u) << 32) | (uint32_t)out_docs[i];
    }
    size_t kk = merge_k > 0 && (size_t)merge_k < n_out ? (size_t)merge_k
                                                       : n_out;
    if (kk < n_out) {
        std::nth_element(keys.begin(), keys.begin() + kk, keys.end());
        keys.resize(kk);
    }
    std::sort(keys.begin(), keys.end());
    std::vector<int32_t> docs2(kk);
    std::vector<float> scores2(kk);
    for (size_t i = 0; i < kk; i++) {
        uint32_t u = ~(uint32_t)(keys[i] >> 32);
        u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
        float s;
        std::memcpy(&s, &u, 4);
        docs2[i] = (int32_t)(keys[i] & 0xffffffffu);
        scores2[i] = s;
    }
    PyObject* docs_b2 = PyBytes_FromStringAndSize(
        (const char*)docs2.data(), kk * 4);
    PyObject* scores_b2 = PyBytes_FromStringAndSize(
        (const char*)scores2.data(), kk * 4);
    PyObject* tup = PyTuple_Pack(2, docs_b2, scores_b2);
    Py_XDECREF(docs_b2);
    Py_XDECREF(scores_b2);
    return tup;
}

// ---------------------------------------------------------------------------
// Dense doc-major merge for FREQUENT terms (large gathered posting sets).
//
// The heap merge above interleaves runs per posting — unpredictable branches
// cost ~25 ns/posting at multi-million-posting frequent words. This variant
// is the reference's own structure (Merger's doc-indexed merge statuses,
// merger.h): a dense [T, cap] accumulator filled run-by-run with ascending-
// doc streaming writes (branch-free scoring, no interleave), then ONE
// combine pass over docs folding proximity/must/not/full-match. O(T*cap)
// memory — the Python router picks it only when G is large enough that the
// memset amortizes (ft/selector.py DENSE_MIN).
// ---------------------------------------------------------------------------

PyObject* score_merge_dense(PyObject* /*self*/, PyObject* args) {
    PyObject *run_start_o, *run_len_o, *run_term_o, *run_w_o, *run_idf_o;
    PyObject *post_doc_o, *post_field_o, *post_tf_o, *post_minpos_o;
    PyObject *doc_words_o, *fb_o, *bb_o, *bw_o, *pb_o, *pw_o;
    PyObject *term_boost_o, *term_lenb_o, *must_o, *notm_o, *field_words_o;
    PyObject *pa_o = Py_None, *pb2_o = Py_None, *pr_o = Py_None;
    double k1, b, avg_len, dist_w, dist_b, fm_boost;
    long bm25_type, use_prox, n_fields, cap, n_terms, use_fm, merge_k;
    if (!PyArg_ParseTuple(
            args, "OOOOOOOOOOOOOOOOOOOdddlddlOlllldl|OOO",
            &run_start_o, &run_len_o, &run_term_o, &run_w_o, &run_idf_o,
            &post_doc_o, &post_field_o, &post_tf_o, &post_minpos_o,
            &doc_words_o, &fb_o, &bb_o, &bw_o, &pb_o, &pw_o,
            &term_boost_o, &term_lenb_o, &must_o, &notm_o,
            &k1, &b, &avg_len, &bm25_type, &dist_w, &dist_b, &use_prox,
            &field_words_o, &n_fields, &cap, &n_terms, &use_fm, &fm_boost,
            &merge_k, &pa_o, &pb2_o, &pr_o)) {
        return nullptr;
    }
    PhraseBuf rs_b, rl_b, rt_b, rw_b, ri_b, post_doc_b, post_field_b,
        post_tf_b, post_minpos_b, doc_words_b, fb_b, bb_b, bw_b, pb_b, pw_b,
        tb_b, tl_b, must_b, notm_b, fw_b, pa_b, pb2_b, pr_b;
    if (!rs_b.get(run_start_o) || !rl_b.get(run_len_o) ||
        !rt_b.get(run_term_o) || !rw_b.get(run_w_o) || !ri_b.get(run_idf_o) ||
        !post_doc_b.get(post_doc_o) || !post_field_b.get(post_field_o) ||
        !post_tf_b.get(post_tf_o) || !post_minpos_b.get(post_minpos_o) ||
        !doc_words_b.get(doc_words_o) || !fb_b.get(fb_o) || !bb_b.get(bb_o) ||
        !bw_b.get(bw_o) || !pb_b.get(pb_o) || !pw_b.get(pw_o) ||
        !tb_b.get(term_boost_o) || !tl_b.get(term_lenb_o) ||
        !must_b.get(must_o) || !notm_b.get(notm_o)) {
        return nullptr;
    }
    bool have_fw = field_words_o != Py_None;
    if (have_fw && !fw_b.get(field_words_o)) return nullptr;
    // precomputed per-posting affine score parts: sr = w*(A[p] + beta*B[p])
    // with beta in run_idf (query-independent A/B built by the selector)
    bool have_ab = pa_o != Py_None && pb2_o != Py_None;
    if (have_ab && (!pa_b.get(pa_o) || !pb2_b.get(pb2_o))) return nullptr;
    const float* PA = have_ab ? (const float*)pa_b.view.buf : nullptr;
    const float* PB = have_ab ? (const float*)pb2_b.view.buf : nullptr;
    // fully-folded per-posting rank PR = A + idf_word*B (idf is a
    // corpus statistic, so PR is query-independent): ONE load + ONE
    // multiply per posting — the merge is memory-bound on one core
    bool have_pr = pr_o != Py_None;
    if (have_pr && !pr_b.get(pr_o)) return nullptr;
    const float* PR = have_pr ? (const float*)pr_b.view.buf : nullptr;

    const int64_t* run_start = (const int64_t*)rs_b.view.buf;
    const int64_t* run_len = (const int64_t*)rl_b.view.buf;
    const int32_t* run_term = (const int32_t*)rt_b.view.buf;
    const float* run_w = (const float*)rw_b.view.buf;
    const float* run_idf = (const float*)ri_b.view.buf;
    const int32_t* post_doc = (const int32_t*)post_doc_b.view.buf;
    const int32_t* post_field = (const int32_t*)post_field_b.view.buf;
    const float* post_tf = (const float*)post_tf_b.view.buf;
    const int32_t* post_minpos = (const int32_t*)post_minpos_b.view.buf;
    const float* doc_words = (const float*)doc_words_b.view.buf;
    const float* fb = (const float*)fb_b.view.buf;
    const float* bb = (const float*)bb_b.view.buf;
    const float* bw = (const float*)bw_b.view.buf;
    const float* pb = (const float*)pb_b.view.buf;
    const float* pw = (const float*)pw_b.view.buf;
    const float* term_boost = (const float*)tb_b.view.buf;
    const float* term_lenb = (const float*)tl_b.view.buf;
    const uint8_t* must = (const uint8_t*)must_b.view.buf;
    const uint8_t* notm = (const uint8_t*)notm_b.view.buf;
    const int32_t* field_words =
        have_fw ? (const int32_t*)fw_b.view.buf : nullptr;
    Py_ssize_t R = rs_b.view.len / 8;
    Py_ssize_t T = must_b.view.len;

    int n_must = 0;
    for (Py_ssize_t t = 0; t < T; t++) n_must += must[t] ? 1 : 0;

    const float k1f = (float)k1, bf = (float)b;
    const float k1p1 = k1f + 1.0f;
    const float kb_base = k1f * (1.0f - bf);
    const float kb_scale = k1f * bf / (float)avg_len;
    const float BIGPOS = 1e9f;
    float* acc;
    float* mp;

    // combine outputs + bounded top-merge_k machinery (declared before the
    // single-term fast path so it can share the select_topk tail): a
    // size-k max-heap of packed keys with a cached threshold replaces
    // collect-all + nth_element; key packing matches the unbounded tail
    // exactly (score desc, doc asc), so results are bit-identical.
    std::vector<int32_t> out_docs;
    std::vector<float> out_scores;
    out_docs.reserve(65536);
    out_scores.reserve(65536);
    const bool bounded = merge_k > 0 && (size_t)merge_k * 8 < (size_t)cap;
    std::vector<uint64_t> hk;
    if (bounded) hk.reserve((size_t)merge_k);
    uint64_t thr = UINT64_MAX;
    auto emit = [&](long d, float s) {
        if (!bounded) {
            out_docs.push_back((int32_t)d);
            out_scores.push_back(s);
            return;
        }
        uint32_t u;
        std::memcpy(&u, &s, 4);
        u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
        uint64_t key = ((uint64_t)(~u) << 32) | (uint32_t)d;
        if (key >= thr) return;
        if (hk.size() < (size_t)merge_k) {
            hk.push_back(key);
            std::push_heap(hk.begin(), hk.end());
            if (hk.size() == (size_t)merge_k) thr = hk.front();
        } else {
            std::pop_heap(hk.begin(), hk.end());
            hk.back() = key;
            std::push_heap(hk.begin(), hk.end());
            thr = hk.front();
        }
    };

    if (T == 1 && R == 1 && !use_prox && !notm[0] && have_pr) {
        // Single term, single variant run (the frequent-singles shape):
        // postings are doc-ascending, so the dense accumulator + full-cap
        // combine scan collapse into ONE pass folding adjacent-duplicate
        // max straight into the bounded heap — no memset, no [cap] scan.
        // The full-match boost (field word count == 1 query term) folds in
        // as one field_words load per candidate doc.
        const float rboost = run_w[0] * term_boost[run_term[0]]
                             * term_lenb[run_term[0]];
        const bool fm = use_fm && have_fw;
        const int64_t s0 = run_start[0], e0 = s0 + run_len[0];
        int64_t pi = s0;
        while (pi < e0) {
            int32_t d = post_doc[pi];
            float sr = rboost * PR[pi];
            pi++;
            while (pi < e0 && post_doc[pi] == d) {
                float s2 = rboost * PR[pi];
                sr = s2 > sr ? s2 : sr;
                pi++;
            }
            if (sr <= 0.f) continue;
            if (fm) {
                for (long f = 0; f < n_fields; f++) {
                    if (fb[f] > 0.f &&
                        field_words[f * cap + d] == (int)n_terms) {
                        sr *= (float)fm_boost;
                        break;
                    }
                }
            }
            emit(d, sr);
        }
        goto select_topk;
    }

    // reused process-lifetime buffers: a fresh 4-8 MB vector per call costs
    // ~1k soft page faults on first touch (measured ~1-2 ms/query at 1M
    // docs); std::fill over warm pages is pure memset bandwidth. The GIL
    // serializes callers. (Raw pointers, not references: the fast path's
    // goto may not cross initializations.)
    static std::vector<float> acc_buf, mp_buf;
    if (acc_buf.size() < (size_t)T * cap) acc_buf.resize((size_t)T * cap);
    std::fill(acc_buf.begin(), acc_buf.begin() + (size_t)T * cap, 0.f);
    acc = acc_buf.data();
    if (use_prox) {
        if (mp_buf.size() < (size_t)T * cap) mp_buf.resize((size_t)T * cap);
        std::fill(mp_buf.begin(), mp_buf.begin() + (size_t)T * cap, BIGPOS);
        mp = mp_buf.data();
    }

    for (Py_ssize_t r = 0; r < R; r++) {
        int32_t t = run_term[r];
        float* at = acc + (size_t)t * cap;
        float* mt = use_prox ? mp + (size_t)t * cap : nullptr;
        const float rboost = run_w[r] * term_boost[t] * term_lenb[t];
        const float idf = run_idf[r];
        const int64_t s0 = run_start[r], e0 = s0 + run_len[r];
        if (have_pr) {
            for (int64_t pi = s0; pi < e0; pi++) {
                int32_t d = post_doc[pi];
                float sr = rboost * PR[pi];
                at[d] = sr > at[d] ? sr : at[d];
                if (mt) {
                    float mpf = (float)post_minpos[pi];
                    mt[d] = mpf < mt[d] ? mpf : mt[d];
                }
            }
            continue;
        }
        if (have_ab) {
            // 2 loads + 2 FMAs per posting (A/B precomputed at build time;
            // per-posting bm25/pos2rank fully factored out)
            const float wB = rboost * idf;
            for (int64_t pi = s0; pi < e0; pi++) {
                int32_t d = post_doc[pi];
                float sr = rboost * PA[pi] + wB * PB[pi];
                at[d] = sr > at[d] ? sr : at[d];
                if (mt) {
                    float mpf = (float)post_minpos[pi];
                    mt[d] = mpf < mt[d] ? mpf : mt[d];
                }
            }
            continue;
        }
        for (int64_t pi = s0; pi < e0; pi++) {
            int32_t d = post_doc[pi];
            int32_t fld = post_field[pi];
            float tf = post_tf[pi];
            float wdoc = doc_words[d];
            wdoc = wdoc < 1.f ? 1.f : wdoc;
            float bm25;
            if (bm25_type == 2) {
                bm25 = tf;
            } else {
                float t_freq = (bm25_type == 1) ? tf / wdoc : tf;
                bm25 = idf * t_freq * k1p1 /
                       (t_freq + kb_base + kb_scale * wdoc);
            }
            float bm25_norm = (1.f - bw[fld]) + bm25 * bb[fld] * bw[fld];
            float mpf = (float)post_minpos[pi];
            float posrank =
                (1.f - pw[fld]) + pos2rank(mpf) * pb[fld] * pw[fld];
            float sr = fb[fld] * rboost * bm25_norm * posrank;
            at[d] = sr > at[d] ? sr : at[d];
            if (mt) mt[d] = mpf < mt[d] ? mpf : mt[d];
        }
    }

    // combine pass: per doc, terms ascending (same fold as the heap merge)
    if (T == 2 && n_must == 0 && !notm[0] && !notm[1] &&
        (!use_fm || !have_fw || n_fields == 1)) {
        // frequent two-term OR (the common zipf-head query), two phases:
        // phase A is a BRANCHLESS per-doc combine g++ auto-vectorizes
        // (selects + one div lane-wise, identical float ops to the scalar
        // loop), written in place over acc row 0; phase B scans 16-doc
        // blocks and skips any whose max cannot beat the heap threshold —
        // after the heap warms, almost every block is one max + one
        // compare. Mispredict-free vs the per-doc emit loop (~2x at 1M).
        const float* a1 = acc + cap;
        const float* m0 = use_prox ? mp : nullptr;
        const float* m1 = use_prox ? mp + cap : nullptr;
        const float c1 = (float)(1.0 - dist_w);
        const float c2 = (float)(dist_b * dist_w);
        const bool fm2 = use_fm && have_fw && (int)n_terms == 2 &&
                         n_fields == 1 && fb[0] > 0.f;
        const float fmb = (float)fm_boost;
        float* ds = acc;                    // in-place over a0
        if (use_prox) {
            for (long d = 0; d < cap; d++) {
                float s0v = ds[d], s1v = a1[d];
                float dist = m1[d] > m0[d] ? m1[d] - m0[d] : m0[d] - m1[d];
                dist = dist < 1.f ? 1.f : dist;
                bool both = (s0v > 0.f) & (s1v > 0.f);
                float att1 = both ? s1v * (c1 + c2 / dist) : s1v;
                float docsum = (s0v > 0.f ? s0v : 0.f)
                               + (s1v > 0.f ? att1 : 0.f);
                if (fm2)
                    docsum = (both & (field_words[d] == 2))
                                 ? docsum * fmb : docsum;
                ds[d] = docsum;
            }
        } else {
            for (long d = 0; d < cap; d++) {
                float s0v = ds[d], s1v = a1[d];
                bool both = (s0v > 0.f) & (s1v > 0.f);
                float docsum = (s0v > 0.f ? s0v : 0.f)
                               + (s1v > 0.f ? s1v : 0.f);
                if (fm2)
                    docsum = (both & (field_words[d] == 2))
                                 ? docsum * fmb : docsum;
                ds[d] = docsum;
            }
        }
        long d = 0;
        float thr_f = -1.f;
        for (; d + 16 <= cap; d += 16) {
            float bm = ds[d];
            for (int j = 1; j < 16; j++)
                bm = ds[d + j] > bm ? ds[d + j] : bm;
            bool full = bounded && hk.size() == (size_t)merge_k;
            if (bm <= 0.f || (full && bm < thr_f)) continue;
            for (int j = 0; j < 16; j++) {
                float v = ds[d + j];
                if (v > 0.f) emit(d + j, v);
            }
            if (bounded && hk.size() == (size_t)merge_k) {
                uint32_t u = ~(uint32_t)(hk.front() >> 32);
                u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
                std::memcpy(&thr_f, &u, 4);
            }
        }
        for (; d < cap; d++)
            if (ds[d] > 0.f) emit(d, ds[d]);
        goto select_topk;
    }
    for (long d = 0; d < cap; d++) {
        double docsum = 0.0;
        bool excl = false;
        int must_cnt = 0, pos_cnt = 0;
        float carry = 0.f;
        bool hasp = false;
        bool any = false;
        for (Py_ssize_t t = 0; t < T; t++) {
            float smax = acc[(size_t)t * cap + d];
            if (smax <= 0.f) continue;
            any = true;
            float att = smax;
            float pmin = use_prox ? mp[(size_t)t * cap + d] : 0.f;
            if (use_prox && hasp) {
                float dist = pmin > carry ? pmin - carry : carry - pmin;
                if (dist < 1.f) dist = 1.f;
                att = smax * ((float)(1.0 - dist_w) +
                              (float)(dist_b * dist_w) / dist);
            }
            if (!notm[t]) {
                docsum += att;
                pos_cnt++;
                carry = pmin;
                hasp = true;
            } else {
                excl = true;
            }
            if (must[t]) must_cnt++;
        }
        if (!any || excl || must_cnt != n_must || docsum <= 0.0) continue;
        if (use_fm && have_fw && pos_cnt == (int)n_terms) {
            for (long f = 0; f < n_fields; f++) {
                if (fb[f] > 0.f &&
                    field_words[f * cap + d] == (int)n_terms) {
                    docsum *= fm_boost;
                    break;
                }
            }
        }
        emit(d, (float)docsum);
    }

select_topk: {
    std::vector<uint64_t> keys;
    if (bounded) {
        keys.swap(hk);
    } else {
        size_t n_out = out_docs.size();
        keys.resize(n_out);
        for (size_t i = 0; i < n_out; i++) {
            uint32_t u;
            float s = out_scores[i];
            std::memcpy(&u, &s, 4);
            u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
            keys[i] = ((uint64_t)(~u) << 32) | (uint32_t)out_docs[i];
        }
        size_t kk0 = merge_k > 0 && (size_t)merge_k < n_out
                         ? (size_t)merge_k : n_out;
        if (kk0 < n_out) {
            std::nth_element(keys.begin(), keys.begin() + kk0, keys.end());
            keys.resize(kk0);
        }
    }
    std::sort(keys.begin(), keys.end());
    size_t kk = keys.size();
    std::vector<int32_t> docs2(kk);
    std::vector<float> scores2(kk);
    for (size_t i = 0; i < kk; i++) {
        uint32_t u = ~(uint32_t)(keys[i] >> 32);
        u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
        float s;
        std::memcpy(&s, &u, 4);
        docs2[i] = (int32_t)(keys[i] & 0xffffffffu);
        scores2[i] = s;
    }
    PyObject* docs_b2 = PyBytes_FromStringAndSize(
        (const char*)docs2.data(), kk * 4);
    PyObject* scores_b2 = PyBytes_FromStringAndSize(
        (const char*)scores2.data(), kk * 4);
    PyObject* tup = PyTuple_Pack(2, docs_b2, scores_b2);
    Py_XDECREF(docs_b2);
    Py_XDECREF(scores_b2);
    return tup;
}
}

PyMethodDef methods[] = {
    {"build_tokens", build_tokens, METH_VARARGS,
     "build_tokens(docs, extra_symbols) -> (vocab, token_ids, doc_ids, "
     "field_ids, positions)"},
    {"score_merge", score_merge, METH_VARARGS,
     "score_merge(...) -> (doc_ids bytes i32, scores bytes f32) — host "
     "BM25 merge of gathered postings (mergerimpl.h:95-124 analog)"},
    {"score_merge_runs", score_merge_runs, METH_VARARGS,
     "score_merge_runs(...) -> (doc_ids bytes i32, scores bytes f32) — "
     "sort-free k-way merge over presorted per-variant posting runs with "
     "in-C top-merge_k (mergerimpl.h:95-124 analog)"},
    {"score_merge_dense", score_merge_dense, METH_VARARGS,
     "score_merge_dense(...) -> (doc_ids bytes i32, scores bytes f32) — "
     "dense [T, cap] doc-major merge for frequent terms (merger.h merge "
     "statuses analog); same args as score_merge_runs"},
    {"verify_phrases", verify_phrases, METH_VARARGS,
     "verify_phrases(post_doc, post_field, pos_start, pos_flat, docs, "
     "slot_ranges, dist) -> bytes mask"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ft_native",
    "Native FT tokenizer/vocab builder", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__ft_native(void) {
    return PyModule_Create(&moduledef);
}
