// Native typo-dictionary builder (the
// port's copy of reindexer_tpu/csrc/typos_native.cpp; built with g++ by
// reindexer_tpu_torch/csrc/__init__.py).
//
// Native-footprint equivalent of the reference's typo-map build
// (cpp_src/core/ft/ft_fast/dataprocessor.cc buildTyposMap +
// ft/typos.cc): for every vocabulary word generate its character-deletion
// forms (symmetric-delete dictionary) and map form -> word ids. The Python
// fallback (ft/typos.py TypoDict.add_word loop) produces identical contents;
// this runs the hot loop in C++ with CPython unicode substrings so deletion
// semantics match exactly.
//
//   build_typo_dict(words, max_deletes, min_len, max_len, max_candidates)
//       -> dict[str, list[int]]

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <string>
#include <unordered_set>
#include <vector>

namespace {

// append the deletion forms of `word` (unicode object) into `forms`,
// recursing up to `depth` single-character deletions
int gen_deletions(PyObject* word, int depth,
                  std::unordered_set<std::string>& seen,
                  std::vector<PyObject*>& forms) {
    Py_ssize_t len = PyUnicode_GET_LENGTH(word);
    for (Py_ssize_t i = 0; i < len; i++) {
        PyObject* left = PyUnicode_Substring(word, 0, i);
        PyObject* right = PyUnicode_Substring(word, i + 1, len);
        if (!left || !right) {
            Py_XDECREF(left);
            Py_XDECREF(right);
            return -1;
        }
        PyObject* form = PyUnicode_Concat(left, right);
        Py_DECREF(left);
        Py_DECREF(right);
        if (!form) return -1;
        Py_ssize_t usize;
        const char* utf8 = PyUnicode_AsUTF8AndSize(form, &usize);
        if (!utf8) {
            Py_DECREF(form);
            return -1;
        }
        std::string key(utf8, (size_t)usize);
        if (seen.insert(key).second) {
            if (depth > 1) {
                if (gen_deletions(form, depth - 1, seen, forms) < 0) {
                    Py_DECREF(form);
                    return -1;
                }
            }
            forms.push_back(form);   // ownership moves to caller
        } else {
            Py_DECREF(form);
        }
    }
    return 0;
}

PyObject* build_typo_dict(PyObject* /*self*/, PyObject* args) {
    PyObject* words;
    int max_deletes, min_len, max_len, max_candidates;
    if (!PyArg_ParseTuple(args, "Oiiii", &words, &max_deletes, &min_len,
                          &max_len, &max_candidates))
        return nullptr;
    PyObject* out = PyDict_New();
    if (!out) return nullptr;
    PyObject* seq = PySequence_Fast(words, "words must be a sequence");
    if (!seq) {
        Py_DECREF(out);
        return nullptr;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t wid = 0; wid < n; wid++) {
        PyObject* word = PySequence_Fast_GET_ITEM(seq, wid);
        if (!PyUnicode_Check(word)) continue;
        Py_ssize_t wlen = PyUnicode_GET_LENGTH(word);
        if (wlen < min_len || wlen > max_len) continue;
        std::unordered_set<std::string> seen;
        // the word itself must not appear as its own deletion form
        {
            Py_ssize_t usize;
            const char* utf8 = PyUnicode_AsUTF8AndSize(word, &usize);
            if (utf8) seen.emplace(utf8, (size_t)usize);
        }
        std::vector<PyObject*> forms;
        if (gen_deletions(word, max_deletes, seen, forms) < 0) {
            for (PyObject* f : forms) Py_DECREF(f);
            Py_DECREF(seq);
            Py_DECREF(out);
            return nullptr;
        }
        for (PyObject* form : forms) {
            PyObject* lst = PyDict_GetItem(out, form);   // borrowed
            if (lst == nullptr) {
                lst = PyList_New(0);
                if (!lst || PyDict_SetItem(out, form, lst) < 0) {
                    Py_XDECREF(lst);
                    Py_DECREF(form);
                    continue;
                }
                Py_DECREF(lst);  // dict holds it
                lst = PyDict_GetItem(out, form);
            }
            if (PyList_GET_SIZE(lst) < max_candidates) {
                PyObject* id = PyLong_FromSsize_t(wid);
                PyList_Append(lst, id);
                Py_DECREF(id);
            }
            Py_DECREF(form);
        }
    }
    Py_DECREF(seq);
    return out;
}

PyMethodDef methods[] = {
    {"build_typo_dict", build_typo_dict, METH_VARARGS,
     "build_typo_dict(words, max_deletes, min_len, max_len, max_candidates)"
     " -> dict[str, list[int]]"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_typos_native",
    "Native symmetric-delete typo dictionary builder", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__typos_native(void) {
    return PyModule_Create(&moduledef);
}
