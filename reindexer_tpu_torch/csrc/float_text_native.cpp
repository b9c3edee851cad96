// The JSON text of a list of floats, as json.dumps writes it: the host lane
// of the per-document checksum (core/namespace.py, _item_hash; built with
// g++ by reindexer_tpu_torch/csrc/__init__.py).
//
// The checksum is blake2b over json.dumps(doc, sort_keys=True,
// separators=(",", ":"), default=str), and a float's text there is its
// repr: about 1 us a float in the interpreter, most of the cost of hashing
// a document that holds a vector. This module writes the same bytes:
//
//   float_list_text(seq) -> bytes | None
//
// seq: a list or tuple (exact types). Returns b"[x0,x1,...]" when every
// item is exactly a float, else None (the caller encodes it with json).
// Each xi is Python's repr of the double: the shortest digits that round
// trip (std::to_chars, GCC 11 or later), laid out as float_repr does (the
// 'r' format of PyOS_double_to_string): fixed notation when the decimal
// point's position decpt (value = 0.d1d2... x 10^decpt) is in -3..16, with
// ".0" on an integral value and "-0.0" for negative zero; else d.ddde+XX
// with a sign and at least two exponent digits; and json's NaN, Infinity
// and -Infinity.
//
//   untrack_float_list(seq) -> bool
//
// Takes a list of exact floats (a stored vector) out of the cyclic
// collector's walk, as CPython itself untracks a tuple or dict of atomic
// values: such a list holds no container, so it can close no cycle, and a
// full collection no longer visits each of its floats. Returns whether it
// did; any other object is left as it is.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <charconv>
#include <cmath>
#include <cstring>
#include <string>

namespace {

// the longest repr of a double: sign, 17 digits, '.', "e-308"
constexpr size_t kMaxRepr = 24;

char* put_repr(char* p, double v) {
    if (std::isnan(v)) {
        std::memcpy(p, "NaN", 3);
        return p + 3;
    }
    if (std::isinf(v)) {
        if (v < 0) *p++ = '-';
        std::memcpy(p, "Infinity", 8);
        return p + 8;
    }
    char buf[32];
    const auto res = std::to_chars(buf, buf + sizeof buf, v,
                                   std::chars_format::scientific);
    const char* s = buf;
    const char* end = res.ptr;
    if (*s == '-') {
        *p++ = '-';
        ++s;
    }
    // s: d[.ddd]e(+|-)XX[X]
    const char* e = static_cast<const char*>(std::memchr(s, 'e', end - s));
    char digits[20];
    int n = 0;
    for (const char* c = s; c < e; ++c)
        if (*c != '.') digits[n++] = *c;
    int exp = 0;
    for (const char* c = e + 2; c < end; ++c) exp = 10 * exp + (*c - '0');
    if (e[1] == '-') exp = -exp;
    const int decpt = exp + 1;
    if (decpt <= -4 || decpt > 16) {
        // to_chars's own exponent form is repr's: sign, two digits or more
        std::memcpy(p, s, end - s);
        return p + (end - s);
    }
    if (decpt <= 0) {
        *p++ = '0';
        *p++ = '.';
        for (int i = 0; i < -decpt; ++i) *p++ = '0';
        std::memcpy(p, digits, n);
        return p + n;
    }
    if (decpt >= n) {
        std::memcpy(p, digits, n);
        p += n;
        for (int i = n; i < decpt; ++i) *p++ = '0';
        *p++ = '.';
        *p++ = '0';
        return p;
    }
    std::memcpy(p, digits, decpt);
    p += decpt;
    *p++ = '.';
    std::memcpy(p, digits + decpt, n - decpt);
    return p + (n - decpt);
}

PyObject* float_list_text(PyObject*, PyObject* seq) {
    if (!PyList_CheckExact(seq) && !PyTuple_CheckExact(seq)) Py_RETURN_NONE;
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject** items = PySequence_Fast_ITEMS(seq);
    for (Py_ssize_t i = 0; i < n; ++i)
        if (!PyFloat_CheckExact(items[i])) Py_RETURN_NONE;
    std::string out(2 + static_cast<size_t>(n) * (kMaxRepr + 1), '\0');
    char* p = out.data();
    *p++ = '[';
    for (Py_ssize_t i = 0; i < n; ++i) {
        if (i) *p++ = ',';
        p = put_repr(p, PyFloat_AS_DOUBLE(items[i]));
    }
    *p++ = ']';
    return PyBytes_FromStringAndSize(out.data(), p - out.data());
}

PyObject* untrack_float_list(PyObject*, PyObject* seq) {
    if (!PyList_CheckExact(seq)) Py_RETURN_FALSE;
    const Py_ssize_t n = PyList_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; ++i)
        if (!PyFloat_CheckExact(PyList_GET_ITEM(seq, i))) Py_RETURN_FALSE;
    PyObject_GC_UnTrack(seq);
    Py_RETURN_TRUE;
}

PyMethodDef methods[] = {
    {"float_list_text", float_list_text, METH_O,
     "float_list_text(list | tuple) -> json.dumps's bytes of a list of "
     "exact floats, or None"},
    {"untrack_float_list", untrack_float_list, METH_O,
     "untrack_float_list(obj) -> whether obj, a list of exact floats, was "
     "taken out of the cyclic collector's walk"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_float_text_native",
    "json.dumps's text of a list of floats", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__float_text_native(void) {
    return PyModule_Create(&moduledef);
}
