// Native scalar-query fast lane.
//
// The reference executes scalar selects in C++ (cpp_src/core/nsselecter/
// nsselecter.cc selectLoop: the most selective SelectIterator drives the
// scan, comparators probe only its rows; readme.md:126 publishes the
// resulting 1-core headlines: 500K point / 50K composite / 20K join qps).
// The pure-Python executor mirrors that model (query/executor.py
// _fast_and_rows) but pays CPython interpreter density on every query:
// the measured profile is ~25us/point select spread over dozens of small
// dict/attr/numpy calls, with no single hotspot.
//
// This module collapses the per-query work into ONE native call. It walks
// the LIVE Python engine structures (index posting dicts/sets from
// index/scalar.py, numpy column buffers from core/payload.py Column) under
// the namespace lock, so there is no mirror state to maintain and no
// coherence protocol: Python remains the source of truth, C is a faster
// interpreter for the same data.
//
// Safety contract (parity with query/executor.py):
//   - Any query shape, value type, condition, or index kind this file does
//     not handle EXACTLY like the Python paths returns None ("bail"), and
//     the caller falls back to the Python implementation. Unsure == bail.
//   - Value-type gates mirror coerce_scalar (core/payload.py:297): e.g. a
//     float literal against an int hash index bails (Python truncates it),
//     a str literal against a numeric field bails. Posting-dict probes with
//     the ORIGINAL value object are only allowed where Python's numeric
//     hash invariant (hash(5) == hash(5.0)) makes them key-equal to the
//     coerce_scalar()-coerced stored key; inexact int->double cases bail.
//   - Probe semantics mirror query/comparators.py column_mask_rows /
//     _scalar_mask / _array_mask (posting membership is equivalent for
//     indexed fields; see tests/test_scalar_native.py for the enforced
//     oracle equivalence).
//   - Join entries are not evaluated here: their positions are returned to
//     the caller, which probes them at the surviving candidate rows
//     (executor._join_matches(only_rows=ids)). AND/NOT probes commute, so
//     applying joins after the scalar entries is result-identical.
//
// knn_items builds the ResultItems of Reindexer.knn_batch the same way:
// one call a search result, the Python loop its twin and fallback.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// small RAII ref holder
// ---------------------------------------------------------------------
struct Ref {
  PyObject* p;
  explicit Ref(PyObject* o = nullptr) : p(o) {}
  ~Ref() { Py_XDECREF(p); }
  Ref(const Ref&) = delete;
  Ref& operator=(const Ref&) = delete;
  PyObject* get() const { return p; }
  PyObject* release() {
    PyObject* o = p;
    p = nullptr;
    return o;
  }
  explicit operator bool() const { return p != nullptr; }
};

// module-level state: type objects + interned attribute names, installed
// once from Python via setup()
static PyObject* g_qe_type = nullptr;       // query.QueryEntry
static PyObject* g_jq_type = nullptr;       // query.JoinedQuery
static PyObject* g_ri_type = nullptr;       // results.ResultItem (optional)

static PyObject* S(const char* s) { return PyUnicode_InternFromString(s); }
static PyObject *s_field, *s_condition, *s_values, *s__post, *s_sets,
    *s__rows_with_value, *s_data, *s_is_set, *s_size, *s_is_fulltext,
    *s_is_vector, *s_is_composite, *s_opts, *s_is_array, *s_field_type,
    *s_value;

// CondType values (core/type_consts.py)
enum {
  C_ANY = 0, C_EQ = 1, C_LT = 2, C_LE = 3, C_GT = 4, C_GE = 5,
  C_RANGE = 6, C_SET = 7, C_ALLSET = 8, C_EMPTY = 9,
};
// OpType values
enum { OP_OR = 1, OP_AND = 2, OP_NOT = 3 };

// field value kinds we can evaluate natively
enum FKind { FK_INT = 0, FK_DOUBLE = 1, FK_STRING = 2, FK_BOOL = 3, FK_OTHER = 4 };

struct FieldMeta {
  PyObject* sets = nullptr;      // dict key -> set(rows)   (strong)
  PyObject* rows_any = nullptr;  // set(rows with a value)  (strong)
  PyObject* column = nullptr;    // payload.Column or NULL  (strong)
  int fkind = FK_OTHER;
  bool is_array = false;
  bool hash_ok = false;      // sets/rows_any usable (plain Hash/Tree index)
  bool unsupported = false;  // fulltext / vector / composite: bail if touched
};

static void fieldmeta_destroy(PyObject* capsule) {
  auto* fm = static_cast<FieldMeta*>(
      PyCapsule_GetPointer(capsule, "rx.FieldMeta"));
  if (fm) {
    Py_XDECREF(fm->sets);
    Py_XDECREF(fm->rows_any);
    Py_XDECREF(fm->column);
    delete fm;
  }
}

// ---------------------------------------------------------------------
// build_meta(fields, columns) -> dict name -> FieldMeta capsule
//   fields:  executor._fast_meta(ns)["fields"]  {name: (index, idef)}
//   columns: ns.columns                          {name: Column}
// The capsule holds STRONG refs to live, in-place-mutated containers
// (index._post.sets, index._rows_with_value, the Column object); the
// caller re-keys its cache on Namespace.schema_version, which bumps on
// every add/drop/update_index (core/namespace.py:162,183).
// ---------------------------------------------------------------------
static PyObject* build_meta(PyObject*, PyObject* args) {
  PyObject *fields, *columns;
  if (!PyArg_ParseTuple(args, "OO", &fields, &columns)) return nullptr;
  if (!PyDict_Check(fields) || !PyDict_Check(columns)) {
    PyErr_SetString(PyExc_TypeError, "build_meta expects two dicts");
    return nullptr;
  }
  Ref out(PyDict_New());
  if (!out) return nullptr;
  PyObject *key, *val;
  Py_ssize_t pos = 0;
  while (PyDict_Next(fields, &pos, &key, &val)) {
    if (!PyTuple_Check(val) || PyTuple_GET_SIZE(val) != 2) continue;
    PyObject* index = PyTuple_GET_ITEM(val, 0);
    PyObject* idef = PyTuple_GET_ITEM(val, 1);
    auto* fm = new FieldMeta();
    PyObject* capsule = PyCapsule_New(fm, "rx.FieldMeta", fieldmeta_destroy);
    if (!capsule) {
      delete fm;
      return nullptr;
    }
    Ref cap(capsule);  // owns fm (and its strong refs) from here on
    Ref ft(PyObject_GetAttr(idef, s_is_fulltext));
    Ref vec(PyObject_GetAttr(idef, s_is_vector));
    Ref comp(PyObject_GetAttr(idef, s_is_composite));
    if (!ft || !vec || !comp) return nullptr;
    fm->unsupported = PyObject_IsTrue(ft.get()) ||
                      PyObject_IsTrue(vec.get()) ||
                      PyObject_IsTrue(comp.get());
    Ref opts(PyObject_GetAttr(idef, s_opts));
    if (opts) {
      Ref arr(PyObject_GetAttr(opts.get(), s_is_array));
      if (arr) fm->is_array = PyObject_IsTrue(arr.get());
    }
    PyErr_Clear();
    // field value kind from idef.field_type (a str-valued enum)
    Ref ftype(PyObject_GetAttr(idef, s_field_type));
    fm->fkind = FK_OTHER;
    if (ftype) {
      Ref fval(PyObject_GetAttr(ftype.get(), s_value));  // enum .value str
      PyObject* fstr = fval ? fval.get() : ftype.get();
      if (PyUnicode_Check(fstr)) {
        if (PyUnicode_CompareWithASCIIString(fstr, "int") == 0 ||
            PyUnicode_CompareWithASCIIString(fstr, "int64") == 0)
          fm->fkind = FK_INT;
        else if (PyUnicode_CompareWithASCIIString(fstr, "double") == 0)
          fm->fkind = FK_DOUBLE;
        else if (PyUnicode_CompareWithASCIIString(fstr, "string") == 0)
          fm->fkind = FK_STRING;
        else if (PyUnicode_CompareWithASCIIString(fstr, "bool") == 0)
          fm->fkind = FK_BOOL;
      }
      PyErr_Clear();
    } else {
      PyErr_Clear();
    }
    // posting containers: only the plain HashIndex/TreeIndex family keeps
    // raw (uncoerced-beyond-coerce_scalar) keys; UuidIndex packs keys to
    // 128-bit ints and CompositeIndex keys are tuples -> those fields get
    // hash_ok=false (their fkind is FK_OTHER / unsupported anyway)
    if (fm->fkind != FK_OTHER && !fm->unsupported) {
      Ref post(PyObject_GetAttr(index, s__post));
      if (post) {
        Ref sets(PyObject_GetAttr(post.get(), s_sets));
        Ref any(PyObject_GetAttr(index, s__rows_with_value));
        if (sets && any && PyDict_Check(sets.get()) &&
            PySet_Check(any.get())) {
          fm->sets = sets.release();
          fm->rows_any = any.release();
          fm->hash_ok = true;
        }
      }
      PyErr_Clear();
    }
    PyObject* col = PyDict_GetItem(columns, key);  // borrowed
    if (col) {
      Py_INCREF(col);
      fm->column = col;
    }
    if (PyDict_SetItem(out.get(), key, cap.get()) < 0) return nullptr;
  }
  return out.release();
}

// ---------------------------------------------------------------------
// column buffer view (payload.Column: .data numpy array, .is_set bool
// array, .size logical length; rows >= size are unset)
// ---------------------------------------------------------------------
struct ColView {
  Py_buffer data{};
  Py_buffer mask{};
  long long size = 0;
  bool ok = false;
  bool is_f64 = false;
  ~ColView() {
    if (data.obj) PyBuffer_Release(&data);
    if (mask.obj) PyBuffer_Release(&mask);
  }
  const int64_t* i64() const { return static_cast<const int64_t*>(data.buf); }
  const double* f64() const { return static_cast<const double*>(data.buf); }
  const uint8_t* set() const { return static_cast<const uint8_t*>(mask.buf); }
};

static bool get_col_view(PyObject* column, int fkind, ColView* out) {
  if (!column) return false;
  Ref data(PyObject_GetAttr(column, s_data));
  Ref mask(PyObject_GetAttr(column, s_is_set));
  Ref size(PyObject_GetAttr(column, s_size));
  if (!data || !mask || !size) {
    PyErr_Clear();
    return false;
  }
  long long sz = PyLong_AsLongLong(size.get());
  if (sz < 0 && PyErr_Occurred()) {
    PyErr_Clear();
    return false;
  }
  if (PyObject_GetBuffer(data.get(), &out->data, PyBUF_FORMAT | PyBUF_ND) <
      0) {
    PyErr_Clear();
    return false;
  }
  if (PyObject_GetBuffer(mask.get(), &out->mask, PyBUF_FORMAT | PyBUF_ND) <
      0) {
    PyErr_Clear();
    PyBuffer_Release(&out->data);
    out->data.obj = nullptr;
    return false;
  }
  if (out->data.ndim != 1 || out->mask.ndim != 1 ||
      out->mask.itemsize != 1 || out->data.itemsize != 8)
    return false;
  const char* f = out->data.format ? out->data.format : "";
  if (fkind == FK_INT) {
    if (!(f[0] == 'l' || f[0] == 'q')) return false;
    out->is_f64 = false;
  } else if (fkind == FK_DOUBLE) {
    if (f[0] != 'd') return false;
    out->is_f64 = true;
  } else {
    return false;
  }
  if (out->data.shape[0] < sz || out->mask.shape[0] < sz) return false;
  out->size = sz;
  out->ok = true;
  return true;
}

// ---------------------------------------------------------------------
// value-type gates (mirror core/payload.py coerce_scalar exactness rules:
// anything coerce_scalar would TRANSFORM in a way the raw value's hash
// can't follow bails; anything Python's numeric hash invariant already
// unifies — int(True)==1, hash(5)==hash(5.0) — probes with the raw value)
// ---------------------------------------------------------------------
static bool value_as_i64(PyObject* v, int64_t* out) {
  if (!PyLong_Check(v)) return false;
  int overflow = 0;
  long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (overflow != 0) return false;
  *out = x;
  return true;
}

static bool value_as_f64(PyObject* v, double* out) {
  if (PyFloat_Check(v)) {
    *out = PyFloat_AS_DOUBLE(v);
    return true;
  }
  if (PyLong_Check(v)) {
    double x = PyLong_AsDouble(v);
    if (x == -1.0 && PyErr_Occurred()) {
      PyErr_Clear();
      return false;
    }
    *out = x;
    return true;
  }
  return false;
}

static bool value_ok_for_hash(PyObject* v, int fkind) {
  if (v == Py_None) return false;
  if (fkind == FK_INT) return PyLong_Check(v) != 0;  // bool: int(True)==1 key-equal
  if (fkind == FK_DOUBLE) {
    if (PyFloat_Check(v)) return true;
    if (PyLong_Check(v)) {
      // stored keys are float(value); the raw int probes key-equal only
      // when the int->double round trip is exact (hash(5)==hash(5.0))
      int overflow = 0;
      long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
      if (overflow != 0) return false;
      double d = static_cast<double>(x);
      if (d >= 9.2233720368547758e18 || d < -9.2233720368547758e18)
        return false;
      return static_cast<long long>(d) == x;
    }
    return false;
  }
  if (fkind == FK_STRING) return PyUnicode_Check(v) != 0;
  if (fkind == FK_BOOL) {
    if (PyBool_Check(v)) return true;
    if (PyLong_Check(v)) {
      long x = PyLong_AsLong(v);
      return x == 0 || x == 1;  // bool(x) key-equal to x only for 0/1
    }
    return false;
  }
  return false;
}

// ---------------------------------------------------------------------
// conjunction evaluation
// ---------------------------------------------------------------------
struct Ent {
  int op = OP_AND;
  PyObject* entry = nullptr;  // borrowed
  FieldMeta* fm = nullptr;
  long cond = -1;
  PyObject* values = nullptr;  // borrowed tuple (the entry keeps it alive)
  long long est = -1;          // driver eligibility estimate (-1: not eligible)
};

enum EvalStatus { EV_OK = 0, EV_BAIL = 1, EV_ERR = 2 };

// driver row extraction from posting sets; rows filtered to live items
static bool collect_set_rows(PyObject* set, PyObject* items, long long cap,
                             std::vector<long long>& rows) {
  Ref it(PyObject_GetIter(set));
  if (!it) return false;
  PyObject* o;
  while ((o = PyIter_Next(it.get())) != nullptr) {
    long long r = PyLong_AsLongLong(o);
    Py_DECREF(o);
    if (r == -1 && PyErr_Occurred()) return false;
    if (r >= 0 && r < cap && PyList_GET_ITEM(items, r) != Py_None)
      rows.push_back(r);
  }
  return !PyErr_Occurred();
}

// probe one entry at candidate rows; keep[i] set to the match verdict.
// returns EV_BAIL when the entry can't be probed natively.
static EvalStatus probe_entry(const Ent& e,
                              const std::vector<long long>& rows,
                              std::vector<char>& keep) {
  const size_t nr = rows.size();
  const Py_ssize_t nv = e.values ? PyTuple_GET_SIZE(e.values) : 0;

  // ---- posting-set membership (hash/tree indexes; array fields too:
  // upsert adds one posting per element, so membership == _array_mask's
  // any-element semantics) ----
  if (e.cond == C_ANY || e.cond == C_EMPTY) {
    PyObject* any = e.fm->rows_any;
    for (size_t i = 0; i < nr; i++) {
      Ref ro(PyLong_FromLongLong(rows[i]));
      if (!ro) return EV_ERR;
      int in = PySet_Contains(any, ro.get());
      if (in < 0) return EV_ERR;
      keep[i] = (e.cond == C_ANY) ? (in != 0) : (in == 0);
    }
    return EV_OK;
  }

  if ((e.cond == C_EQ || e.cond == C_SET || e.cond == C_ALLSET) &&
      e.fm->hash_ok) {
    // pre-resolve the per-key posting sets (borrowed refs; dict is stable
    // under the namespace lock)
    std::vector<PyObject*> sets;
    sets.reserve((size_t)nv);
    bool missing_key = false;
    for (Py_ssize_t k = 0; k < nv; k++) {
      PyObject* s =
          PyDict_GetItemWithError(e.fm->sets, PyTuple_GET_ITEM(e.values, k));
      if (!s) {
        if (PyErr_Occurred()) return EV_ERR;
        missing_key = true;
        continue;
      }
      sets.push_back(s);
    }
    if (e.cond == C_ALLSET) {
      // row must be in EVERY requested key's postings
      if (missing_key || nv == 0) {
        std::fill(keep.begin(), keep.end(), 0);
        return EV_OK;
      }
      for (size_t i = 0; i < nr; i++) {
        Ref ro(PyLong_FromLongLong(rows[i]));
        if (!ro) return EV_ERR;
        char ok = 1;
        for (PyObject* s : sets) {
          int in = PySet_Contains(s, ro.get());
          if (in < 0) return EV_ERR;
          if (!in) {
            ok = 0;
            break;
          }
        }
        keep[i] = ok;
      }
      return EV_OK;
    }
    // EQ / SET: union membership
    for (size_t i = 0; i < nr; i++) {
      Ref ro(PyLong_FromLongLong(rows[i]));
      if (!ro) return EV_ERR;
      char ok = 0;
      for (PyObject* s : sets) {
        int in = PySet_Contains(s, ro.get());
        if (in < 0) return EV_ERR;
        if (in) {
          ok = 1;
          break;
        }
      }
      keep[i] = ok;
    }
    return EV_OK;
  }

  // ---- numeric scalar column probes (range conditions on any index;
  // EQ/SET/ALLSET on store-index fields) — mirror column_mask_rows:
  // rows at/beyond Column.size are unset and never match ----
  if (e.fm->is_array || !e.fm->column ||
      (e.fm->fkind != FK_INT && e.fm->fkind != FK_DOUBLE))
    return EV_BAIL;
  ColView cv;
  if (!get_col_view(e.fm->column, e.fm->fkind, &cv)) return EV_BAIL;
  const uint8_t* iset = cv.set();

  if (e.cond == C_EQ || e.cond == C_SET || e.cond == C_ALLSET) {
    if (cv.is_f64) {
      std::vector<double> cs;
      cs.reserve((size_t)nv);
      for (Py_ssize_t k = 0; k < nv; k++) {
        double d;
        if (!value_as_f64(PyTuple_GET_ITEM(e.values, k), &d)) return EV_BAIL;
        cs.push_back(d);
      }
      if (e.cond == C_ALLSET) {
        // scalar column matches ALLSET only when all requested values equal
        bool all_eq = !cs.empty();
        for (double d : cs) all_eq = all_eq && (d == cs[0]);
        if (!all_eq) {
          std::fill(keep.begin(), keep.end(), 0);
          return EV_OK;
        }
        cs.resize(1);
      }
      const double* vals = cv.f64();
      for (size_t i = 0; i < nr; i++) {
        long long r = rows[i];
        char ok = 0;
        if (r < cv.size && iset[r]) {
          double v = vals[r];
          if (e.cond == C_EQ) {
            ok = (nv > 0 && v == cs[0]);
          } else {
            for (double d : cs)
              if (v == d) {
                ok = 1;
                break;
              }
          }
        }
        keep[i] = ok;
      }
    } else {
      std::vector<int64_t> cs;
      cs.reserve((size_t)nv);
      for (Py_ssize_t k = 0; k < nv; k++) {
        int64_t x;
        if (!value_as_i64(PyTuple_GET_ITEM(e.values, k), &x)) return EV_BAIL;
        cs.push_back(x);
      }
      if (e.cond == C_ALLSET) {
        bool all_eq = !cs.empty();
        for (int64_t x : cs) all_eq = all_eq && (x == cs[0]);
        if (!all_eq) {
          std::fill(keep.begin(), keep.end(), 0);
          return EV_OK;
        }
        cs.resize(1);
      }
      const int64_t* vals = cv.i64();
      for (size_t i = 0; i < nr; i++) {
        long long r = rows[i];
        char ok = 0;
        if (r < cv.size && iset[r]) {
          int64_t v = vals[r];
          if (e.cond == C_EQ) {
            ok = (nv > 0 && v == cs[0]);
          } else {
            for (int64_t x : cs)
              if (v == x) {
                ok = 1;
                break;
              }
          }
        }
        keep[i] = ok;
      }
    }
    return EV_OK;
  }

  // range conditions
  if (cv.is_f64) {
    double lo = 0, hi = 0;
    if (!value_as_f64(PyTuple_GET_ITEM(e.values, 0), &lo)) return EV_BAIL;
    if (e.cond == C_RANGE) {
      if (!value_as_f64(PyTuple_GET_ITEM(e.values, 1), &hi)) return EV_BAIL;
      if (hi < lo) std::swap(lo, hi);
    }
    const double* vals = cv.f64();
    for (size_t i = 0; i < nr; i++) {
      long long r = rows[i];
      char ok = 0;
      if (r < cv.size && iset[r]) {
        double v = vals[r];
        switch (e.cond) {
          case C_LT: ok = v < lo; break;
          case C_LE: ok = v <= lo; break;
          case C_GT: ok = v > lo; break;
          case C_GE: ok = v >= lo; break;
          case C_RANGE: ok = v >= lo && v <= hi; break;
        }
      }
      keep[i] = ok;
    }
  } else {
    int64_t lo = 0, hi = 0;
    if (!value_as_i64(PyTuple_GET_ITEM(e.values, 0), &lo)) return EV_BAIL;
    if (e.cond == C_RANGE) {
      if (!value_as_i64(PyTuple_GET_ITEM(e.values, 1), &hi)) return EV_BAIL;
      if (hi < lo) std::swap(lo, hi);
    }
    const int64_t* vals = cv.i64();
    for (size_t i = 0; i < nr; i++) {
      long long r = rows[i];
      char ok = 0;
      if (r < cv.size && iset[r]) {
        int64_t v = vals[r];
        switch (e.cond) {
          case C_LT: ok = v < lo; break;
          case C_LE: ok = v <= lo; break;
          case C_GT: ok = v > lo; break;
          case C_GE: ok = v >= lo; break;
          case C_RANGE: ok = v >= lo && v <= hi; break;
        }
      }
      keep[i] = ok;
    }
  }
  return EV_OK;
}

static EvalStatus eval_conjunction(PyObject* meta, PyObject* entries,
                                   PyObject* items,
                                   std::vector<Py_ssize_t>& joins,
                                   std::vector<long long>& out) {
  if (!PyList_Check(entries) || !PyList_Check(items)) return EV_BAIL;
  const Py_ssize_t n = PyList_GET_SIZE(entries);
  if (n == 0) return EV_BAIL;  // select-all: mask path owns it
  const long long cap = PyList_GET_SIZE(items);
  long long est_cap = cap >> 2;
  if (est_cap < 64) est_cap = 64;
  if (est_cap > 4096) est_cap = 4096;  // executor._FAST_AND_MAX_DRIVER

  std::vector<Ent> ents;
  ents.reserve(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* t = PyList_GET_ITEM(entries, i);
    if (!PyTuple_Check(t) || PyTuple_GET_SIZE(t) != 2) return EV_BAIL;
    Ent e;
    {
      long op = PyLong_AsLong(PyTuple_GET_ITEM(t, 0));
      if (op == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        return EV_BAIL;
      }
      if (op == OP_OR) return EV_BAIL;  // disjunctions: Python paths
      e.op = (int)op;
    }
    e.entry = PyTuple_GET_ITEM(t, 1);
    if (Py_TYPE(e.entry) == (PyTypeObject*)g_jq_type) {
      joins.push_back(i);  // probed by the caller at the surviving rows
      continue;
    }
    if (Py_TYPE(e.entry) != (PyTypeObject*)g_qe_type) return EV_BAIL;
    Ref field(PyObject_GetAttr(e.entry, s_field));
    Ref cond(PyObject_GetAttr(e.entry, s_condition));
    Ref values(PyObject_GetAttr(e.entry, s_values));
    if (!field || !cond || !values) {
      PyErr_Clear();
      return EV_BAIL;
    }
    if (!PyUnicode_Check(field.get()) || !PyTuple_Check(values.get()))
      return EV_BAIL;
    if (PyUnicode_GET_LENGTH(field.get()) > 0 &&
        PyUnicode_READ_CHAR(field.get(), 0) == '#')
      return EV_BAIL;  // system fields (#lsn etc.): WAL/Python paths
    e.cond = PyLong_AsLong(cond.get());
    if (e.cond == -1 && PyErr_Occurred()) {
      PyErr_Clear();
      return EV_BAIL;
    }
    PyObject* cap_obj = PyDict_GetItem(meta, field.get());  // borrowed
    if (!cap_obj) return EV_BAIL;  // non-indexed field: strict-mode paths
    e.fm = static_cast<FieldMeta*>(
        PyCapsule_GetPointer(cap_obj, "rx.FieldMeta"));
    if (!e.fm) {
      PyErr_Clear();
      return EV_BAIL;
    }
    if (e.fm->unsupported || e.fm->fkind == FK_OTHER) return EV_BAIL;
    // borrow the values tuple: the entry object (alive in `entries`) holds
    // a reference for the duration of this call
    e.values = values.get();

    const Py_ssize_t nv = PyTuple_GET_SIZE(e.values);
    // multi-value EQ is ambiguous even between the Python paths
    // (select_key unions all keys, _scalar_mask compares cvals[0] only);
    // it is unreachable from the builders — bail rather than pick a side
    if (e.cond == C_EQ && nv != 1) return EV_BAIL;
    switch (e.cond) {
      case C_EQ:
      case C_SET:
      case C_ALLSET: {
        if (!e.fm->hash_ok) {
          // store-index fields: numeric scalar column comparators only
          if (e.fm->is_array || !e.fm->column ||
              (e.fm->fkind != FK_INT && e.fm->fkind != FK_DOUBLE))
            return EV_BAIL;
          for (Py_ssize_t k = 0; k < nv; k++) {
            PyObject* v = PyTuple_GET_ITEM(e.values, k);
            int64_t ti;
            double td;
            if (e.fm->fkind == FK_INT ? !value_as_i64(v, &ti)
                                      : !value_as_f64(v, &td))
              return EV_BAIL;
          }
          break;  // probe-only via column
        }
        long long est = 0;
        bool first = true;
        for (Py_ssize_t k = 0; k < nv; k++) {
          PyObject* v = PyTuple_GET_ITEM(e.values, k);
          if (!value_ok_for_hash(v, e.fm->fkind)) return EV_BAIL;
          PyObject* s = PyDict_GetItemWithError(e.fm->sets, v);
          if (!s && PyErr_Occurred()) {
            PyErr_Clear();
            return EV_BAIL;
          }
          long long sz = s ? (long long)PySet_GET_SIZE(s) : 0;
          if (e.cond == C_ALLSET) {
            est = first ? sz : (sz < est ? sz : est);
            first = false;
            if (!s) est = 0;
          } else {
            est += sz;
          }
        }
        if (e.op == OP_AND) e.est = est;
        break;
      }
      case C_ANY:
      case C_EMPTY: {
        if (!e.fm->hash_ok) return EV_BAIL;
        if (e.cond == C_ANY && e.op == OP_AND)
          e.est = (long long)PySet_GET_SIZE(e.fm->rows_any);
        break;
      }
      case C_LT:
      case C_LE:
      case C_GT:
      case C_GE:
      case C_RANGE: {
        if (e.fm->is_array || !e.fm->column ||
            (e.fm->fkind != FK_INT && e.fm->fkind != FK_DOUBLE))
          return EV_BAIL;
        const Py_ssize_t need = (e.cond == C_RANGE) ? 2 : 1;
        if (nv < need) return EV_BAIL;
        for (Py_ssize_t k = 0; k < need; k++) {
          PyObject* v = PyTuple_GET_ITEM(e.values, k);
          if (v == Py_None) return EV_BAIL;
          int64_t ti;
          double td;
          if (e.fm->fkind == FK_INT) {
            if (!PyLong_Check(v)) return EV_BAIL;  // floats truncate in coerce
            if (!value_as_i64(v, &ti)) return EV_BAIL;
          } else {
            if (!value_as_f64(v, &td)) return EV_BAIL;
          }
        }
        break;
      }
      default:
        return EV_BAIL;  // LIKE / DWITHIN / KNN: Python paths
    }
    ents.push_back(e);
  }
  if (ents.empty()) return EV_BAIL;  // join-only conjunction: Python paths

  // driver pick: smallest posting estimate among AND hash entries
  int driver = -1;
  long long best = -1;
  for (size_t i = 0; i < ents.size(); i++) {
    if (ents[i].est >= 0 && ents[i].est <= est_cap &&
        (best < 0 || ents[i].est < best)) {
      best = ents[i].est;
      driver = (int)i;
    }
  }
  if (driver < 0) return EV_BAIL;

  // extract + sort driver rows
  std::vector<long long> rows;
  rows.reserve((size_t)best + 1);
  {
    const Ent& d = ents[driver];
    if (d.cond == C_ANY) {
      if (!collect_set_rows(d.fm->rows_any, items, cap, rows)) return EV_ERR;
    } else if (d.cond == C_ALLSET) {
      // iterate the smallest key set; the entry itself is re-probed below
      PyObject* smallest = nullptr;
      Py_ssize_t ssz = 0;
      const Py_ssize_t nv = PyTuple_GET_SIZE(d.values);
      for (Py_ssize_t k = 0; k < nv; k++) {
        PyObject* s =
            PyDict_GetItemWithError(d.fm->sets, PyTuple_GET_ITEM(d.values, k));
        if (!s) {
          PyErr_Clear();
          smallest = nullptr;
          break;
        }
        if (!smallest || PySet_GET_SIZE(s) < ssz) {
          smallest = s;
          ssz = PySet_GET_SIZE(s);
        }
      }
      if (smallest && !collect_set_rows(smallest, items, cap, rows))
        return EV_ERR;
      if (nv == 0) {
        // ALLSET over no keys matches nothing (HashIndex.select_key:165)
      }
    } else {  // EQ / SET union over keys
      const Py_ssize_t nv = PyTuple_GET_SIZE(d.values);
      for (Py_ssize_t k = 0; k < nv; k++) {
        PyObject* s =
            PyDict_GetItemWithError(d.fm->sets, PyTuple_GET_ITEM(d.values, k));
        if (!s) {
          if (PyErr_Occurred()) return EV_ERR;
          continue;
        }
        if (!collect_set_rows(s, items, cap, rows)) return EV_ERR;
      }
    }
  }
  std::sort(rows.begin(), rows.end());
  rows.erase(std::unique(rows.begin(), rows.end()), rows.end());

  // probe the remaining entries (EQ/SET/ANY drivers are exact: skip re-probe)
  for (size_t i = 0; i < ents.size(); i++) {
    if (rows.empty()) break;  // AND/NOT only: nothing revives an empty set
    const Ent& e = ents[i];
    if ((int)i == driver &&
        (e.cond == C_EQ || e.cond == C_SET || e.cond == C_ANY))
      continue;
    std::vector<char> keep(rows.size(), 0);
    EvalStatus st = probe_entry(e, rows, keep);
    if (st != EV_OK) return st;
    const bool want = (e.op != OP_NOT);
    size_t w = 0;
    for (size_t r = 0; r < rows.size(); r++)
      if ((keep[r] != 0) == want) rows[w++] = rows[r];
    rows.resize(w);
  }
  out.swap(rows);
  return EV_OK;
}

// ---------------------------------------------------------------------
// Python surface
// ---------------------------------------------------------------------
static PyObject* setup(PyObject*, PyObject* args) {
  PyObject *qe, *jq, *ri = nullptr;
  if (!PyArg_ParseTuple(args, "OO|O", &qe, &jq, &ri)) return nullptr;
  if (!PyType_Check(qe) || !PyType_Check(jq) ||
      (ri && !PyType_Check(ri))) {
    PyErr_SetString(PyExc_TypeError, "setup expects type objects");
    return nullptr;
  }
  Py_INCREF(qe);
  Py_XDECREF(g_qe_type);
  g_qe_type = qe;
  Py_INCREF(jq);
  Py_XDECREF(g_jq_type);
  g_jq_type = jq;
  Py_XINCREF(ri);
  Py_XDECREF(g_ri_type);
  g_ri_type = ri;
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------
// point_items(fm_capsule, cond, values, items, limit, ns_name)
//   -> None (bail) | list[ResultItem]
// The native core of executor._fast_point_select: probe the posting dict
// for EQ/SET keys, take the first `limit` candidate rows (limit applies
// BEFORE liveness filtering, mirroring `res.ids[:limit]` + the None-doc
// skip in the Python loop), and materialize ResultItem(doc, row, None,
// {}, ns_name) for each live row. Single-key probes keep the posting
// set's iteration order (== np.fromiter(set) in the Python path);
// multi-key SET probes sort + dedup (== np.unique(concatenate)).
// Projection/vector stripping is not handled here: the caller only
// enters with no select_filter and no vector-excluded paths.
// ---------------------------------------------------------------------
static PyObject* point_items(PyObject*, PyObject* args) {
  PyObject *cap_obj, *values, *items, *ns_name;
  long cond;
  long long limit;  // -1: unlimited
  if (!PyArg_ParseTuple(args, "OlOOLO", &cap_obj, &cond, &values, &items,
                        &limit, &ns_name))
    return nullptr;
  if (!g_ri_type || !PyTuple_Check(values) || !PyList_Check(items))
    Py_RETURN_NONE;
  auto* fm =
      static_cast<FieldMeta*>(PyCapsule_GetPointer(cap_obj, "rx.FieldMeta"));
  if (!fm) {
    PyErr_Clear();
    Py_RETURN_NONE;
  }
  if (!fm->hash_ok || fm->unsupported || fm->fkind == FK_OTHER)
    Py_RETURN_NONE;
  if (cond != C_EQ && cond != C_SET) Py_RETURN_NONE;
  const Py_ssize_t nv = PyTuple_GET_SIZE(values);
  if (cond == C_EQ && nv != 1) Py_RETURN_NONE;
  const long long cap = PyList_GET_SIZE(items);

  // resolve posting sets with the exactness gates
  std::vector<PyObject*> sets;  // borrowed
  sets.reserve((size_t)nv);
  for (Py_ssize_t k = 0; k < nv; k++) {
    PyObject* v = PyTuple_GET_ITEM(values, k);
    if (!value_ok_for_hash(v, fm->fkind)) Py_RETURN_NONE;
    PyObject* s = PyDict_GetItemWithError(fm->sets, v);
    if (!s) {
      if (PyErr_Occurred()) return nullptr;
      continue;
    }
    sets.push_back(s);
  }

  std::vector<long long> rows;
  if (sets.size() == 1) {
    // keep set-iteration order; collect raw ids (liveness applied below)
    Ref it(PyObject_GetIter(sets[0]));
    if (!it) return nullptr;
    PyObject* o;
    while ((o = PyIter_Next(it.get())) != nullptr) {
      long long r = PyLong_AsLongLong(o);
      Py_DECREF(o);
      if (r == -1 && PyErr_Occurred()) return nullptr;
      rows.push_back(r);
    }
    if (PyErr_Occurred()) return nullptr;
  } else if (sets.size() > 1) {
    for (PyObject* s : sets) {
      Ref it(PyObject_GetIter(s));
      if (!it) return nullptr;
      PyObject* o;
      while ((o = PyIter_Next(it.get())) != nullptr) {
        long long r = PyLong_AsLongLong(o);
        Py_DECREF(o);
        if (r == -1 && PyErr_Occurred()) return nullptr;
        rows.push_back(r);
      }
      if (PyErr_Occurred()) return nullptr;
    }
    std::sort(rows.begin(), rows.end());
    rows.erase(std::unique(rows.begin(), rows.end()), rows.end());
  }
  if (limit >= 0 && (long long)rows.size() > limit) rows.resize(limit);

  Ref out(PyList_New(0));
  if (!out) return nullptr;
  for (long long r : rows) {
    if (r < 0 || r >= cap) continue;
    PyObject* doc = PyList_GET_ITEM(items, r);  // borrowed
    if (doc == Py_None) continue;
    Ref row_obj(PyLong_FromLongLong(r));
    Ref joined(PyDict_New());
    if (!row_obj || !joined) return nullptr;
    Ref item(PyObject_CallFunctionObjArgs(g_ri_type, doc, row_obj.get(),
                                          Py_None, joined.get(), ns_name,
                                          nullptr));
    if (!item) return nullptr;
    if (PyList_Append(out.get(), item.get()) < 0) return nullptr;
  }
  return out.release();
}

// ---------------------------------------------------------------------
// knn_items(items, ids, ranks, vector_names, ns_name)
//   -> None (bail) | list[ResultItem]
// The native core of core/database.py::_knn_results, one search result a
// call: for each id in order, the live row's document copied into a new
// dict without the top-level keys that name a vector index, as
// ResultItem(doc, row, rank, {}, ns_name). Ids out of [0, len(items)) and
// deleted rows are skipped (Namespace.get_item); the float32 rank widens
// to the double float(np.float32) gives. ranks None gives no items. Bails
// on ids that are not a contiguous 1-d int64 buffer, ranks not float32,
// unequal lengths, a document that is not a plain dict or a key that is
// not a plain str.
// ---------------------------------------------------------------------
struct Buffer {
  Py_buffer view;
  bool held = false;
  ~Buffer() {
    if (held) PyBuffer_Release(&view);
  }
  // a contiguous 1-d buffer of one-character format `code` (native order)
  // and `size` bytes an element; false (no error set) otherwise
  bool take(PyObject* o, char code, Py_ssize_t size) {
    if (PyObject_GetBuffer(o, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0) {
      PyErr_Clear();
      return false;
    }
    held = true;
    const char* f = view.format ? view.format : "B";
    if (*f == '@' || *f == '=' || *f == '<') f++;
    // numpy names int64 'l' where long is 64 bits; itemsize checks that
    return view.ndim == 1 && view.itemsize == size &&
           (f[0] == code || (code == 'q' && f[0] == 'l')) && f[1] == '\0';
  }
  Py_ssize_t len() const { return view.shape[0]; }
};

static PyObject* knn_items(PyObject*, PyObject* args) {
  PyObject *items, *ids, *ranks, *vec, *ns_name;
  if (!PyArg_ParseTuple(args, "OOOOO", &items, &ids, &ranks, &vec, &ns_name))
    return nullptr;
  if (!g_ri_type || !PyList_Check(items) || !PyFrozenSet_Check(vec))
    Py_RETURN_NONE;
  if (ranks == Py_None) return PyList_New(0);
  Buffer bi, br;
  if (!bi.take(ids, 'q', 8) || !br.take(ranks, 'f', 4) ||
      bi.len() != br.len())
    Py_RETURN_NONE;
  const auto* rid = static_cast<const int64_t*>(bi.view.buf);
  const auto* rk = static_cast<const float*>(br.view.buf);
  const Py_ssize_t n = bi.len();
  const Py_ssize_t cap = PyList_GET_SIZE(items);

  Ref out(PyList_New(0));
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    const int64_t r = rid[i];
    if (r < 0 || r >= cap) continue;
    PyObject* doc = PyList_GET_ITEM(items, r);  // borrowed
    if (doc == Py_None) continue;
    if (!PyDict_CheckExact(doc)) Py_RETURN_NONE;
    Ref copy(PyDict_New());
    if (!copy) return nullptr;
    Py_ssize_t pos = 0;
    PyObject *k, *v;  // borrowed
    while (PyDict_Next(doc, &pos, &k, &v)) {
      if (!PyUnicode_CheckExact(k)) Py_RETURN_NONE;
      const int skip = PySet_Contains(vec, k);
      if (skip < 0) return nullptr;
      if (!skip && PyDict_SetItem(copy.get(), k, v) < 0) return nullptr;
    }
    Ref row_obj(PyLong_FromLongLong(r));
    Ref rank_obj(PyFloat_FromDouble(static_cast<double>(rk[i])));
    Ref joined(PyDict_New());
    if (!row_obj || !rank_obj || !joined) return nullptr;
    PyObject* argv[] = {copy.get(), row_obj.get(), rank_obj.get(),
                        joined.get(), ns_name};
    Ref item(PyObject_Vectorcall(g_ri_type, argv, 5, nullptr));
    if (!item) return nullptr;
    if (PyList_Append(out.get(), item.get()) < 0) return nullptr;
  }
  return out.release();
}

// eval_and(meta, entries, items)
//   -> None (bail: caller runs the Python paths)
//   -> (rows_bytearray_int64, join_positions_tuple)
static PyObject* eval_and(PyObject*, PyObject* args) {
  PyObject *meta, *entries, *items;
  if (!PyArg_ParseTuple(args, "OOO", &meta, &entries, &items)) return nullptr;
  if (!g_qe_type || !g_jq_type || !PyDict_Check(meta)) Py_RETURN_NONE;
  std::vector<Py_ssize_t> joins;
  std::vector<long long> rows;
  EvalStatus st = eval_conjunction(meta, entries, items, joins, rows);
  if (st == EV_BAIL) Py_RETURN_NONE;
  if (st == EV_ERR) {
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_RuntimeError, "scalar_native internal error");
    return nullptr;
  }
  static_assert(sizeof(long long) == 8, "int64 rows");
  Ref ba(PyByteArray_FromStringAndSize(
      reinterpret_cast<const char*>(rows.data()),
      (Py_ssize_t)(rows.size() * sizeof(long long))));
  if (!ba) return nullptr;
  Ref jt(PyTuple_New((Py_ssize_t)joins.size()));
  if (!jt) return nullptr;
  for (size_t i = 0; i < joins.size(); i++) {
    PyObject* p = PyLong_FromSsize_t(joins[i]);
    if (!p) return nullptr;
    PyTuple_SET_ITEM(jt.get(), (Py_ssize_t)i, p);
  }
  return Py_BuildValue("(NN)", ba.release(), jt.release());
}

static PyMethodDef methods[] = {
    {"setup", setup, METH_VARARGS,
     "setup(QueryEntry, JoinedQuery[, ResultItem]): install engine types"},
    {"point_items", point_items, METH_VARARGS,
     "point_items(fm, cond, values, items, limit, ns_name)"
     " -> None | list[ResultItem]"},
    {"knn_items", knn_items, METH_VARARGS,
     "knn_items(items, ids, ranks, vector_names, ns_name)"
     " -> None | list[ResultItem]"},
    {"build_meta", build_meta, METH_VARARGS,
     "build_meta(fields, columns) -> {name: FieldMeta capsule}"},
    {"eval_and", eval_and, METH_VARARGS,
     "eval_and(meta, entries, items) -> None | (rows_int64_bytes, joins)"},
    {nullptr, nullptr, 0, nullptr},
};

static PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "scalar_native",
    "Native id-space conjunction evaluation for scalar selects", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit_scalar_native(void) {
  s_field = S("field");
  s_condition = S("condition");
  s_values = S("values");
  s__post = S("_post");
  s_sets = S("sets");
  s__rows_with_value = S("_rows_with_value");
  s_data = S("data");
  s_is_set = S("is_set");
  s_size = S("size");
  s_is_fulltext = S("is_fulltext");
  s_is_vector = S("is_vector");
  s_is_composite = S("is_composite");
  s_opts = S("opts");
  s_is_array = S("is_array");
  s_field_type = S("field_type");
  s_value = S("value");
  return PyModule_Create(&moduledef);
}
