// Native HNSW link maintenance: the host-side graph-builder hot loop (the
// port's copy of reindexer_tpu/csrc/hnsw_native.cpp; built with g++ by
// reindexer_tpu_torch/csrc/__init__.py).
//
// Native equivalent of the reference's link-update code in
// cpp_src/core/index/float_vector/hnswlib/hnswalg.h
// (mutuallyConnectNewElement :1043 — forward links + reverse edges with
// prune on overflow). The batched candidate search and neighbor-selection
// heuristic run on the device (reindexer_tpu_torch/ops/hnsw_kernels.py);
// this module applies the resulting link updates to the host neighbor
// tables at C++ speed. The Python fallback
// (reindexer_tpu_torch/index/vector/hnsw.py, HnswIndex._connect_selected)
// is semantically identical (tests enforce exact parity).
//
//   connect_batch(links, vecs, rows, sel, m_l, metric) -> list[int] dirty
//
// links: int32[cap, m_l] C-contiguous writable; vecs: float32[cap, D];
// rows: int32[B]; sel: int32[B, S] heuristic-selected neighbor ids (-1 pad),
// metric: 0 = L2 (min distance keeps), 1 = IP/cosine (max dot keeps).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

struct Buf {
    Py_buffer view{};
    bool ok = false;
    ~Buf() {
        if (ok) PyBuffer_Release(&view);
    }
    bool get(PyObject* obj, int flags) {
        if (PyObject_GetBuffer(obj, &view, flags) != 0) return false;
        ok = true;
        return true;
    }
};

inline float dist_l2(const float* a, const float* b, Py_ssize_t d) {
    float acc = 0.f;
    for (Py_ssize_t i = 0; i < d; i++) {
        float t = a[i] - b[i];
        acc += t * t;
    }
    return acc;
}

inline float dist_ip(const float* a, const float* b, Py_ssize_t d) {
    float acc = 0.f;
    for (Py_ssize_t i = 0; i < d; i++) acc += a[i] * b[i];
    return -acc;  // negated: smaller = better, same as L2
}

PyObject* connect_batch(PyObject* /*self*/, PyObject* args) {
    PyObject *links_o, *vecs_o, *rows_o, *sel_o;
    int m_l, metric;
    if (!PyArg_ParseTuple(args, "OOOOii", &links_o, &vecs_o, &rows_o, &sel_o,
                          &m_l, &metric))
        return nullptr;

    Buf links, vecs, rows, sel;
    if (!links.get(links_o, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) ||
        !vecs.get(vecs_o, PyBUF_C_CONTIGUOUS) ||
        !rows.get(rows_o, PyBUF_C_CONTIGUOUS) ||
        !sel.get(sel_o, PyBUF_C_CONTIGUOUS))
        return nullptr;
    if (links.view.ndim != 2 || vecs.view.ndim != 2 || rows.view.ndim != 1 ||
        sel.view.ndim != 2) {
        PyErr_SetString(PyExc_ValueError, "bad array ranks");
        return nullptr;
    }
    int32_t* L = (int32_t*)links.view.buf;
    const float* V = (const float*)vecs.view.buf;
    const int32_t* R = (const int32_t*)rows.view.buf;
    const int32_t* S = (const int32_t*)sel.view.buf;
    const Py_ssize_t cap = links.view.shape[0];
    const Py_ssize_t width = links.view.shape[1];
    const Py_ssize_t D = vecs.view.shape[1];
    const Py_ssize_t B = rows.view.shape[0];
    const Py_ssize_t Swidth = sel.view.shape[1];
    if (m_l > width) {
        PyErr_SetString(PyExc_ValueError, "m_l exceeds link width");
        return nullptr;
    }
    auto dist = (metric == 0) ? dist_l2 : dist_ip;

    std::unordered_set<int32_t> dirty;
    std::vector<int32_t> nbrs;
    std::vector<std::pair<float, int32_t>> cand;
    for (Py_ssize_t j = 0; j < B; j++) {
        int32_t row = R[j];
        if (row < 0 || row >= cap) continue;
        nbrs.clear();
        for (Py_ssize_t t = 0; t < Swidth && (Py_ssize_t)nbrs.size() < m_l;
             t++) {
            int32_t s = S[j * Swidth + t];
            if (s >= 0 && s != row && s < cap) nbrs.push_back(s);
        }
        int32_t* lrow = L + (Py_ssize_t)row * width;
        for (Py_ssize_t t = 0; t < width; t++) lrow[t] = -1;
        for (size_t t = 0; t < nbrs.size(); t++) lrow[t] = nbrs[t];
        dirty.insert(row);

        // reverse edges: free slot or prune-to-closest (matches the Python
        // fallback's keep-m-closest policy)
        for (int32_t s : nbrs) {
            int32_t* srow = L + (Py_ssize_t)s * width;
            Py_ssize_t free_at = -1;
            for (Py_ssize_t t = 0; t < m_l; t++) {
                if (srow[t] < 0) {
                    free_at = t;
                    break;
                }
            }
            if (free_at >= 0) {
                srow[free_at] = row;
            } else {
                // overflow: re-run the neighbor-selection heuristic over
                // (existing links + new edge) relative to s — keeping only
                // the closest erodes graph diversity and recall at scale
                // (reference: mutuallyConnectNewElement re-runs
                // getNeighborsByHeuristic2, hnswalg.h:1043)
                cand.clear();
                const float* vs = V + (Py_ssize_t)s * D;
                for (Py_ssize_t t = 0; t < m_l; t++) {
                    int32_t c = srow[t];
                    cand.emplace_back(dist(vs, V + (Py_ssize_t)c * D, D), c);
                }
                cand.emplace_back(dist(vs, V + (Py_ssize_t)row * D, D), row);
                std::stable_sort(cand.begin(), cand.end(),
                                 [](const auto& a, const auto& b) {
                                     return a.first < b.first;
                                 });
                Py_ssize_t kept = 0;
                for (size_t ci = 0; ci < cand.size() && kept < m_l; ci++) {
                    const float dq = cand[ci].first;
                    const int32_t c = cand[ci].second;
                    const float* vc = V + (Py_ssize_t)c * D;
                    bool good = true;
                    for (Py_ssize_t t = 0; t < kept; t++) {
                        if (dist(vc, V + (Py_ssize_t)srow[t] * D, D) < dq) {
                            good = false;
                            break;
                        }
                    }
                    if (good) srow[kept++] = c;
                }
                for (Py_ssize_t t = kept; t < width; t++) srow[t] = -1;
            }
            dirty.insert(s);
        }
    }
    PyObject* out = PyList_New((Py_ssize_t)dirty.size());
    if (!out) return nullptr;
    Py_ssize_t i = 0;
    for (int32_t r : dirty) {
        PyList_SET_ITEM(out, i++, PyLong_FromLong(r));
    }
    return out;
}

PyMethodDef methods[] = {
    {"connect_batch", connect_batch, METH_VARARGS,
     "connect_batch(links, vecs, rows, sel, m_l, metric) -> dirty row list"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hnsw_native",
    "Native HNSW link maintenance", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__hnsw_native(void) {
    return PyModule_Create(&moduledef);
}
