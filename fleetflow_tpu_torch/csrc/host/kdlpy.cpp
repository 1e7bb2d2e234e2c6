// ffkdlpy: CPython-extension assembly of KdlNode trees from the native
// KDL parser (kdl.cpp, compiled into this module). The port's copy of
// native/kdlpy.cpp, built by fleetflow_tpu_torch/_ext.py (host_extension)
// against the running interpreter's Python.h.
//
// The ctypes bridge (fleetflow_tpu_torch/native/kdl.py) exports the parse
// as flat arrays and assembles ~10^5 Python objects per fleet-scale
// document in an interpreter loop, about half of a fleet-scale parse. This
// module does the same assembly in C: one PyUnicode per distinct pooled
// string (the arena interns, so equal strings share an offset), direct
// PyList/PyDict construction, and attribute stores through the class
// passed in by the caller. A parse error returns None and the caller
// reparses in Python, same contract as the ctypes path (so errors keep
// codepoint-exact line/col from the Python parser).
//
// parse_nodes(text: str, node_cls: type) -> list[KdlNode] | None

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {
void* ff_kdl_parse(const char* text, int64_t len, char* errbuf,
                   int64_t errbuf_cap, int32_t* err_line, int32_t* err_col);
void ff_kdl_counts(void* handle, int64_t* n_nodes, int64_t* n_values,
                   int64_t* n_strbytes);
void ff_kdl_export(void* handle, int32_t* parent, int32_t* name_off,
                   int32_t* name_len, int32_t* type_off, int32_t* type_len,
                   int32_t* val_start, int32_t* nargs, int32_t* nprops,
                   uint8_t* vkind, int64_t* vint, double* vnum,
                   int32_t* vstr_off, int32_t* vstr_len, int32_t* vkey_off,
                   int32_t* vkey_len, char* strbuf);
void ff_kdl_free(void* handle);
}

namespace {

// interned attribute names, created once at module init
PyObject* s_name;
PyObject* s_args;
PyObject* s_props;
PyObject* s_children;
PyObject* s_type_annotation;

struct StrCache {
    // the arena interns by content, so distinct strings get distinct
    // offsets — EXCEPT the empty string, whose zero-length append leaves
    // it sharing an offset with whatever lands in the pool next; the key
    // must therefore include the length (caught by test_fuzz_parity on
    // '""node'). Entries hold one owned reference.
    std::unordered_map<int64_t, PyObject*> map;
    const char* buf;

    explicit StrCache(const char* b) : buf(b) {}

    // returns a BORROWED reference (the cache owns it), or nullptr on error
    PyObject* get(int32_t off, int32_t len) {
        int64_t key = (static_cast<int64_t>(off) << 32)
                      | static_cast<uint32_t>(len);
        auto it = map.find(key);
        if (it != map.end()) return it->second;
        PyObject* s = PyUnicode_DecodeUTF8(buf + off, len, "surrogatepass");
        if (s == nullptr) return nullptr;
        map.emplace(key, s);
        return s;
    }

    ~StrCache() {
        for (auto& kv : map) Py_DECREF(kv.second);
    }
};

PyObject* parse_nodes(PyObject*, PyObject* args) {
    const char* text;
    Py_ssize_t tlen;
    PyObject* node_cls;
    if (!PyArg_ParseTuple(args, "s#O", &text, &tlen, &node_cls)) return nullptr;
    if (!PyType_Check(node_cls)) {
        PyErr_SetString(PyExc_TypeError, "node_cls must be a type");
        return nullptr;
    }
    PyTypeObject* cls = reinterpret_cast<PyTypeObject*>(node_cls);
    if (cls->tp_new == nullptr) {
        PyErr_SetString(PyExc_TypeError, "node_cls has no tp_new");
        return nullptr;
    }

    char errbuf[256];
    int32_t eline = 0, ecol = 0;
    void* handle = nullptr;
    int64_t nn = 0, nv = 0, ns = 0;
    std::vector<int32_t> parent, name_off, name_len, type_off, type_len;
    std::vector<int32_t> val_start, nargs_v, nprops_v;
    std::vector<uint8_t> vkind;
    std::vector<int64_t> vint;
    std::vector<double> vnum;
    std::vector<int32_t> vstr_off, vstr_len, vkey_off, vkey_len;
    std::string strbuf;

    // only the parse itself runs without the GIL (ff_kdl_parse catches its
    // own bad_alloc and returns nullptr); the resize/export below happens
    // WITH the GIL held inside a try — a std::bad_alloc escaping a
    // CPython-called frame with the GIL released would std::terminate the
    // process instead of degrading like the ctypes path's MemoryError
    Py_BEGIN_ALLOW_THREADS
    handle = ff_kdl_parse(text, tlen, errbuf, sizeof errbuf, &eline, &ecol);
    Py_END_ALLOW_THREADS

    if (handle == nullptr) Py_RETURN_NONE;  // Python parser decides

    try {
        ff_kdl_counts(handle, &nn, &nv, &ns);
        parent.resize(nn); name_off.resize(nn); name_len.resize(nn);
        type_off.resize(nn); type_len.resize(nn);
        val_start.resize(nn); nargs_v.resize(nn); nprops_v.resize(nn);
        vkind.resize(nv ? nv : 1); vint.resize(nv ? nv : 1);
        vnum.resize(nv ? nv : 1);
        vstr_off.resize(nv ? nv : 1); vstr_len.resize(nv ? nv : 1);
        vkey_off.resize(nv ? nv : 1); vkey_len.resize(nv ? nv : 1);
        strbuf.resize(ns ? ns : 1);
    } catch (const std::bad_alloc&) {
        ff_kdl_free(handle);
        PyErr_NoMemory();
        return nullptr;
    }
    if (nn > 0)
        ff_kdl_export(handle, parent.data(), name_off.data(),
                      name_len.data(), type_off.data(), type_len.data(),
                      val_start.data(), nargs_v.data(), nprops_v.data(),
                      vkind.data(), vint.data(), vnum.data(),
                      vstr_off.data(), vstr_len.data(), vkey_off.data(),
                      vkey_len.data(), strbuf.data());
    ff_kdl_free(handle);

    StrCache cache(strbuf.data());
    std::vector<PyObject*> vals(static_cast<size_t>(nv), nullptr);  // owned
    std::vector<PyObject*> keys(static_cast<size_t>(nv), nullptr);  // owned
    std::vector<PyObject*> nodes(static_cast<size_t>(nn), nullptr); // owned
    std::vector<PyObject*> kids(static_cast<size_t>(nn), nullptr);  // borrowed
    PyObject* top = nullptr;
    PyObject* empty = nullptr;

    // -- values + property keys -------------------------------------------
    for (int64_t j = 0; j < nv; ++j) {
        PyObject* v;
        switch (vkind[j]) {
            case 5: {
                PyObject* s = cache.get(vstr_off[j], vstr_len[j]);
                if (s == nullptr) goto fail;
                v = Py_NewRef(s);
                break;
            }
            case 3: v = PyLong_FromLongLong(vint[j]); break;
            case 4: v = PyFloat_FromDouble(vnum[j]); break;
            case 1: v = Py_NewRef(Py_False); break;
            case 2: v = Py_NewRef(Py_True); break;
            default: v = Py_NewRef(Py_None); break;  // 0 = null; unknown
        }
        if (v == nullptr) goto fail;
        vals[j] = v;
        if (vkey_off[j] >= 0) {
            PyObject* k = cache.get(vkey_off[j], vkey_len[j]);
            if (k == nullptr) goto fail;
            keys[j] = Py_NewRef(k);
        }
    }

    // -- nodes -------------------------------------------------------------
    empty = PyTuple_New(0);
    if (empty == nullptr) goto fail;
    top = PyList_New(0);
    if (top == nullptr) goto fail;
    for (int64_t i = 0; i < nn; ++i) {
        PyObject* node = cls->tp_new(cls, empty, nullptr);
        if (node == nullptr) goto fail;
        nodes[i] = node;

        PyObject* nm = cache.get(name_off[i], name_len[i]);
        if (nm == nullptr || PyObject_SetAttr(node, s_name, nm) < 0) goto fail;

        int32_t vs = val_start[i];
        int32_t na = nargs_v[i];
        int32_t np = nprops_v[i];
        PyObject* arglist = PyList_New(na);
        if (arglist == nullptr) goto fail;
        for (int32_t a = 0; a < na; ++a)
            PyList_SET_ITEM(arglist, a, Py_NewRef(vals[vs + a]));
        int rc = PyObject_SetAttr(node, s_args, arglist);
        Py_DECREF(arglist);
        if (rc < 0) goto fail;

        PyObject* props = PyDict_New();
        if (props == nullptr) goto fail;
        for (int32_t p = 0; p < np; ++p) {
            int64_t j = vs + na + p;
            PyObject* k = keys[j] ? keys[j] : Py_None;
            if (PyDict_SetItem(props, k, vals[j]) < 0) {
                Py_DECREF(props);
                goto fail;
            }
        }
        rc = PyObject_SetAttr(node, s_props, props);
        Py_DECREF(props);
        if (rc < 0) goto fail;

        PyObject* children = PyList_New(0);
        if (children == nullptr) goto fail;
        rc = PyObject_SetAttr(node, s_children, children);
        kids[i] = children;  // borrowed: the node's attribute owns it
        Py_DECREF(children);
        if (rc < 0) goto fail;

        PyObject* ta = Py_None;
        if (type_off[i] >= 0) {
            ta = cache.get(type_off[i], type_len[i]);
            if (ta == nullptr) goto fail;
        }
        if (PyObject_SetAttr(node, s_type_annotation, ta) < 0) goto fail;

        int32_t par = parent[i];
        if (par < 0) {
            if (PyList_Append(top, node) < 0) goto fail;
        } else {
            // parents precede children in arena order
            if (PyList_Append(kids[par], node) < 0) goto fail;
        }
    }

    Py_DECREF(empty);
    for (auto* v : vals) Py_XDECREF(v);
    for (auto* k : keys) Py_XDECREF(k);
    // every node is owned by `top` or its parent's children list now
    for (auto* n : nodes) Py_XDECREF(n);
    return top;

fail:
    Py_XDECREF(empty);
    Py_XDECREF(top);
    for (auto* v : vals) Py_XDECREF(v);
    for (auto* k : keys) Py_XDECREF(k);
    for (auto* n : nodes) Py_XDECREF(n);
    return nullptr;
}

PyMethodDef methods[] = {
    {"parse_nodes", parse_nodes, METH_VARARGS,
     "parse_nodes(text, node_cls) -> list[node_cls] | None (None = fall "
     "back to the Python parser)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "ffkdlpy",
    "Native KDL parse + C-level KdlNode assembly", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_ffkdlpy(void) {
    s_name = PyUnicode_InternFromString("name");
    s_args = PyUnicode_InternFromString("args");
    s_props = PyUnicode_InternFromString("props");
    s_children = PyUnicode_InternFromString("children");
    s_type_annotation = PyUnicode_InternFromString("type_annotation");
    if (!s_name || !s_args || !s_props || !s_children || !s_type_annotation)
        return nullptr;
    return PyModule_Create(&moduledef);
}
