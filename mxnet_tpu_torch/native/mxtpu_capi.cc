// Flat C API implementation over embedded CPython.
//
// Counterpart of the JAX package's native/mxtpu_capi.cc (reference:
// src/c_api/c_api.cc, where C functions wrap the C++ core); here they wrap
// the port by forwarding every call to mxnet_tpu_torch/capi_support.py (the
// marshaling brain). Built as libmxtpu_torch_capi.so (its SONAME too) by
// mxnet_tpu_torch.native.capi.build_capi. This file is deliberately uniform
// glue:
//
//   - handles are `Box*` (one owned PyObject reference + an aux slot for
//     buffers that must outlive the call, e.g. RecordIO reads). Boxing —
//     rather than passing PyObject* straight through — lets MXSymbolCompose
//     keep the reference semantic of mutating the symbol behind the handle.
//   - every entry point: ensure interpreter + GIL -> build args -> call a
//     CApi method -> convert results -> on Python exception, format it into
//     the thread-local error buffer and return -1 (reference:
//     src/c_api/c_api_error.h API_BEGIN/API_END).
//   - string/array returns follow the reference's ownership convention:
//     pointers are valid until the next call on the same thread (kept in
//     thread-local scratch).
//
// Works both embedded (R, standalone C hosts: Py_InitializeEx here, with
// the package on PYTHONPATH) and hosted (loaded via ctypes inside a running
// Python, e.g. the test suite: Py_IsInitialized() is already true and the
// existing interpreter is used). MXNotifyShutdown does not finalize the
// interpreter: an embedded host that used the card exits with it live.

#include "mxtpu_c_api.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <deque>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Box {
  PyObject* obj;
  PyObject* aux;  // keeps byte buffers alive across the C boundary
};

thread_local std::string tls_error;

// scratch that backs pointer returns until the next call on this thread.
// strings is a deque: element addresses stay stable under push_back, so
// c_str() pointers handed out earlier in the SAME call never dangle
struct Scratch {
  std::deque<std::string> strings;
  std::vector<const char*> cstrs;
  std::vector<const char*> cstrs2;
  std::vector<const char*> cstrs3;
  std::vector<mx_uint> uints;
  std::vector<std::vector<mx_uint>> shape_store;
  std::vector<const mx_uint*> shape_ptrs[3];
  std::vector<mx_uint> shape_ndim[3];
  std::vector<void*> handles;
  std::string blob;
};
thread_local Scratch tls_scratch;

PyObject* g_api = nullptr;        // CApi instance
bool g_we_initialized = false;

void set_error_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  tls_error = "unknown python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) tls_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

int ensure_api() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    // release the GIL the init thread holds so PyGILState_Ensure below
    // works uniformly from any thread
    PyEval_SaveThread();
  }
  PyGILState_STATE g = PyGILState_Ensure();
  if (g_api == nullptr) {
    PyObject* mod = PyImport_ImportModule("mxnet_tpu_torch.capi_support");
    if (mod == nullptr) {
      set_error_from_python();
      PyGILState_Release(g);
      return -1;
    }
    PyObject* cls = PyObject_GetAttrString(mod, "CApi");
    Py_DECREF(mod);
    if (cls == nullptr) {
      set_error_from_python();
      PyGILState_Release(g);
      return -1;
    }
    g_api = PyObject_CallNoArgs(cls);
    Py_DECREF(cls);
    if (g_api == nullptr) {
      set_error_from_python();
      PyGILState_Release(g);
      return -1;
    }
  }
  PyGILState_Release(g);
  return 0;
}

struct Gil {
  PyGILState_STATE state;
  Gil() { state = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(state); }
};

// Live-box count per boxed PyObject. Several handles can box the SAME
// underlying object (MXExecutorOutputs and MXDataIterGetData each mint a
// fresh box per call), while the Python side keys MXNDArrayGetData host
// mirrors by that object — so the mirror must only be dropped when the
// LAST box referencing the object dies, not on the first MXNDArrayFree.
// GIL-protected: every box creation/destruction runs under API_ENTER's Gil.
std::unordered_map<PyObject*, int> g_box_counts;

Box* make_box(PyObject* obj /* stolen */) {
  Box* b = new Box{obj, nullptr};
  if (obj != nullptr) ++g_box_counts[obj];
  return b;
}

// Decrement the live-box count for obj; true when this was the last box.
bool last_box_released(PyObject* obj) {
  auto it = g_box_counts.find(obj);
  if (it == g_box_counts.end()) return true;
  if (--it->second > 0) return false;
  g_box_counts.erase(it);
  return true;
}

PyObject* unbox(void* h) { return static_cast<Box*>(h)->obj; }

// vectorized helpers ---------------------------------------------------------
PyObject* handle_list(void** arr, mx_uint n) {
  PyObject* lst = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i) {
    PyObject* o = (arr != nullptr && arr[i] != nullptr)
                      ? unbox(arr[i]) : Py_None;
    Py_INCREF(o);
    PyList_SET_ITEM(lst, i, o);
  }
  return lst;
}

PyObject* str_list(const char** arr, mx_uint n) {
  PyObject* lst = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyUnicode_FromString(arr ? arr[i] : ""));
  return lst;
}

PyObject* int_list(const int* arr, mx_uint n) {
  PyObject* lst = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyLong_FromLong(arr[i]));
  return lst;
}

PyObject* float_list(const mx_float* arr, mx_uint n) {
  PyObject* lst = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyFloat_FromDouble(arr[i]));
  return lst;
}

// call CApi.<method>(...) with a pre-built argument tuple (stolen)
PyObject* call_api(const char* method, PyObject* args_tuple) {
  if (args_tuple == nullptr) return nullptr;  // Py_BuildValue failed
  PyObject* fn = PyObject_GetAttrString(g_api, method);
  if (fn == nullptr) {
    Py_XDECREF(args_tuple);
    return nullptr;
  }
  PyObject* r = PyObject_CallObject(fn, args_tuple);
  Py_DECREF(fn);
  Py_XDECREF(args_tuple);
  return r;
}

// convert python list[str] into a thread-local const char** array
const char** to_cstr_array(PyObject* lst, mx_uint* out_n,
                           std::vector<const char*>* slot) {
  Py_ssize_t n = PyList_Size(lst);
  size_t base = tls_scratch.strings.size();
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* c = PyUnicode_AsUTF8(PyList_GetItem(lst, i));
    tls_scratch.strings.emplace_back(c ? c : "");
  }
  slot->clear();
  for (Py_ssize_t i = 0; i < n; ++i)
    slot->push_back(tls_scratch.strings[base + i].c_str());
  *out_n = static_cast<mx_uint>(n);
  return slot->data();
}

int fail() {
  set_error_from_python();
  return -1;
}

}  // namespace

extern "C" {

const char* MXGetLastError() { return tls_error.c_str(); }

#define API_ENTER()                 \
  if (ensure_api() != 0) return -1; \
  Gil gil;                          \
  tls_scratch.strings.clear()

/* ------------------------------------------------------------- ndarray */

int MXRandomSeed(int seed) {
  API_ENTER();
  PyObject* r = call_api("random_seed", Py_BuildValue("(i)", seed));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXNotifyShutdown() {
  API_ENTER();
  PyObject* r = call_api("notify_shutdown", PyTuple_New(0));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXNDArrayCreateNone(NDArrayHandle* out) {
  API_ENTER();
  PyObject* r = call_api("ndarray_create_none", PyTuple_New(0));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXNDArrayCreate(const mx_uint* shape, mx_uint ndim, int dev_type,
                    int dev_id, int delay_alloc, NDArrayHandle* out) {
  API_ENTER();
  PyObject* shp = PyTuple_New(ndim);
  for (mx_uint i = 0; i < ndim; ++i)
    PyTuple_SET_ITEM(shp, i, PyLong_FromUnsignedLong(shape[i]));
  PyObject* r = call_api(
      "ndarray_create", Py_BuildValue("(Niii)", shp, dev_type, dev_id,
                                      delay_alloc));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXNDArrayLoadFromRawBytes(const void* buf, size_t size,
                              NDArrayHandle* out) {
  API_ENTER();
  PyObject* r = call_api("ndarray_load_raw",
                         Py_BuildValue("(y#)", (const char*)buf,
                                       (Py_ssize_t)size));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXNDArraySaveRawBytes(NDArrayHandle handle, size_t* out_size,
                          const char** out_buf) {
  API_ENTER();
  PyObject* r = call_api("ndarray_save_raw",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  char* data;
  Py_ssize_t len;
  if (PyBytes_AsStringAndSize(r, &data, &len) != 0) {
    Py_DECREF(r);
    return fail();
  }
  tls_scratch.blob.assign(data, len);
  Py_DECREF(r);
  *out_size = tls_scratch.blob.size();
  *out_buf = tls_scratch.blob.data();
  return 0;
}

int MXNDArraySave(const char* fname, mx_uint num_args, NDArrayHandle* args,
                  const char** keys) {
  API_ENTER();
  PyObject* arrs = handle_list(args, num_args);
  PyObject* names = keys ? str_list(keys, num_args) : PyList_New(0);
  PyObject* r = call_api("ndarray_save",
                         Py_BuildValue("(sNN)", fname, arrs, names));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXNDArrayLoad(const char* fname, mx_uint* out_size,
                  NDArrayHandle** out_arr, mx_uint* out_name_size,
                  const char*** out_names) {
  API_ENTER();
  PyObject* r = call_api("ndarray_load", Py_BuildValue("(s)", fname));
  if (!r) return fail();
  PyObject *arrs, *names;
  if (!PyArg_ParseTuple(r, "OO", &arrs, &names)) {
    Py_DECREF(r);
    return fail();
  }
  Py_ssize_t n = PyList_Size(arrs);
  tls_scratch.handles.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* o = PyList_GetItem(arrs, i);
    Py_INCREF(o);
    tls_scratch.handles.push_back(make_box(o));
  }
  *out_size = static_cast<mx_uint>(n);
  *out_arr = tls_scratch.handles.data();
  mx_uint nn = 0;
  *out_names = to_cstr_array(names, &nn, &tls_scratch.cstrs);
  *out_name_size = nn;
  Py_DECREF(r);
  return 0;
}

int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const mx_float* data,
                             size_t size) {
  API_ENTER();
  PyObject* r = call_api(
      "ndarray_sync_copy_from",
      Py_BuildValue("(OKn)", unbox(handle), (unsigned long long)(uintptr_t)data,
                    (Py_ssize_t)size));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, mx_float* data, size_t size) {
  API_ENTER();
  PyObject* r = call_api(
      "ndarray_sync_copy_to",
      Py_BuildValue("(OKn)", unbox(handle), (unsigned long long)(uintptr_t)data,
                    (Py_ssize_t)size));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXNDArrayWaitToRead(NDArrayHandle handle) {
  API_ENTER();
  PyObject* r = call_api("ndarray_wait_to_read",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXNDArrayWaitToWrite(NDArrayHandle handle) {
  return MXNDArrayWaitToRead(handle);
}

int MXNDArrayWaitAll() {
  API_ENTER();
  PyObject* r = call_api("ndarray_wait_all", PyTuple_New(0));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXNDArrayFree(NDArrayHandle handle) {
  if (handle == nullptr) return 0;
  API_ENTER();
  Box* b = static_cast<Box*>(handle);
  if (b->obj != nullptr && last_box_released(b->obj)) {
    // release any host mirror MXNDArrayGetData handed out for this object —
    // only now that no other live handle boxes it (g_box_counts)
    PyObject* r = call_api("ndarray_drop_host_view",
                           Py_BuildValue("(O)", b->obj));
    if (r == nullptr)
      PyErr_Clear();  // freeing must not fail
    else
      Py_DECREF(r);
  }
  Py_XDECREF(b->obj);
  Py_XDECREF(b->aux);
  delete b;
  return 0;
}

int MXNDArraySlice(NDArrayHandle handle, mx_uint lo, mx_uint hi,
                   NDArrayHandle* out) {
  API_ENTER();
  PyObject* r = call_api("ndarray_slice",
                         Py_BuildValue("(OII)", unbox(handle), lo, hi));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXNDArrayGetShape(NDArrayHandle handle, mx_uint* out_dim,
                      const mx_uint** out_pdata) {
  API_ENTER();
  PyObject* r = call_api("ndarray_shape", Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  Py_ssize_t n = PyTuple_Size(r);
  tls_scratch.uints.clear();
  for (Py_ssize_t i = 0; i < n; ++i)
    tls_scratch.uints.push_back(
        (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(r, i)));
  Py_DECREF(r);
  *out_dim = static_cast<mx_uint>(n);
  *out_pdata = tls_scratch.uints.data();
  return 0;
}

int MXNDArrayGetData(NDArrayHandle handle, mx_float** out_pdata) {
  API_ENTER();
  PyObject* r = call_api("ndarray_data_ptr",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  *out_pdata = reinterpret_cast<mx_float*>(PyLong_AsUnsignedLongLong(r));
  Py_DECREF(r);
  return 0;
}

int MXNDArrayGetContext(NDArrayHandle handle, int* out_dev_type,
                        int* out_dev_id) {
  API_ENTER();
  PyObject* r = call_api("ndarray_context",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  if (!PyArg_ParseTuple(r, "ii", out_dev_type, out_dev_id)) {
    Py_DECREF(r);
    return fail();
  }
  Py_DECREF(r);
  return 0;
}

/* ----------------------------------------------------------- functions */

int MXListFunctions(mx_uint* out_size, FunctionHandle** out_array) {
  API_ENTER();
  PyObject* r = call_api("list_functions", PyTuple_New(0));
  if (!r) return fail();
  Py_ssize_t n = PyList_Size(r);
  tls_scratch.handles.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* name = PyList_GetItem(r, i);
    Py_INCREF(name);
    tls_scratch.handles.push_back(make_box(name));
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out_array = const_cast<FunctionHandle*>(
      reinterpret_cast<const void* const*>(tls_scratch.handles.data()));
  return 0;
}

int MXGetFunction(const char* name, FunctionHandle* out) {
  API_ENTER();
  *out = make_box(PyUnicode_FromString(name));
  return 0;
}

int MXFuncGetInfo(FunctionHandle fun, const char** name,
                  const char** description, mx_uint* num_args,
                  const char*** arg_names, const char*** arg_type_infos,
                  const char*** arg_descriptions) {
  API_ENTER();
  PyObject* r = call_api("func_info",
                         Py_BuildValue("(O)", unbox(const_cast<void*>(fun))));
  if (!r) return fail();
  const char *nm, *doc;
  int nuse, nscalar, nmut;
  if (!PyArg_ParseTuple(r, "ssiii", &nm, &doc, &nuse, &nscalar, &nmut)) {
    Py_DECREF(r);
    return fail();
  }
  tls_scratch.strings.emplace_back(nm);
  *name = tls_scratch.strings.back().c_str();
  tls_scratch.strings.emplace_back(doc);
  *description = tls_scratch.strings.back().c_str();
  // arg metadata is not modeled for registered functions (the reference
  // autogenerates it from dmlc docs); report zero args rather than a
  // count the arrays don't back
  (void)nuse;
  (void)nscalar;
  *num_args = 0;
  tls_scratch.cstrs.clear();
  *arg_names = tls_scratch.cstrs.data();
  *arg_type_infos = tls_scratch.cstrs.data();
  *arg_descriptions = tls_scratch.cstrs.data();
  Py_DECREF(r);
  return 0;
}

int MXFuncDescribe(FunctionHandle fun, mx_uint* num_use_vars,
                   mx_uint* num_scalars, mx_uint* num_mutate_vars,
                   int* type_mask) {
  API_ENTER();
  PyObject* r = call_api("func_describe",
                         Py_BuildValue("(O)", unbox(const_cast<void*>(fun))));
  if (!r) return fail();
  int nuse, nscalar, nmut, mask;
  if (!PyArg_ParseTuple(r, "iiii", &nuse, &nscalar, &nmut, &mask)) {
    Py_DECREF(r);
    return fail();
  }
  *num_use_vars = nuse;
  *num_scalars = nscalar;
  *num_mutate_vars = nmut;
  *type_mask = mask;
  Py_DECREF(r);
  return 0;
}

int MXFuncInvoke(FunctionHandle fun, NDArrayHandle* use_vars,
                 mx_float* scalar_args, NDArrayHandle* mutate_vars) {
  API_ENTER();
  mx_uint nuse, nscalar, nmut;
  int mask;
  if (MXFuncDescribe(fun, &nuse, &nscalar, &nmut, &mask) != 0) return -1;
  PyObject* r = call_api(
      "func_invoke",
      Py_BuildValue("(ONNN)", unbox(const_cast<void*>(fun)),
                    handle_list(use_vars, nuse),
                    float_list(scalar_args, nscalar),
                    handle_list(mutate_vars, nmut)));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

/* ------------------------------------------------------------- symbols */

int MXSymbolListAtomicSymbolCreators(mx_uint* out_size,
                                     AtomicSymbolCreator** out_array) {
  API_ENTER();
  PyObject* r = call_api("list_ops", PyTuple_New(0));
  if (!r) return fail();
  Py_ssize_t n = PyList_Size(r);
  tls_scratch.handles.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* name = PyList_GetItem(r, i);
    Py_INCREF(name);
    tls_scratch.handles.push_back(make_box(name));
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out_array = tls_scratch.handles.data();
  return 0;
}

int MXSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator, const char** name,
                                const char** description, mx_uint* num_args,
                                const char*** arg_names,
                                const char*** arg_type_infos,
                                const char*** arg_descriptions,
                                const char** key_var_num_args) {
  API_ENTER();
  PyObject* r = call_api("op_info", Py_BuildValue("(O)", unbox(creator)));
  if (!r) return fail();
  PyObject *names, *types, *descs;
  const char *nm, *doc, *kv;
  if (!PyArg_ParseTuple(r, "ssOOOs", &nm, &doc, &names, &types, &descs, &kv)) {
    Py_DECREF(r);
    return fail();
  }
  tls_scratch.strings.emplace_back(nm);
  *name = tls_scratch.strings.back().c_str();
  tls_scratch.strings.emplace_back(doc);
  *description = tls_scratch.strings.back().c_str();
  tls_scratch.strings.emplace_back(kv);
  *key_var_num_args = tls_scratch.strings.back().c_str();
  mx_uint n = 0;
  *arg_names = to_cstr_array(names, &n, &tls_scratch.cstrs);
  *arg_type_infos = to_cstr_array(types, &n, &tls_scratch.cstrs2);
  *arg_descriptions = to_cstr_array(descs, &n, &tls_scratch.cstrs3);
  *num_args = n;
  Py_DECREF(r);
  return 0;
}

int MXSymbolCreateAtomicSymbol(AtomicSymbolCreator creator, mx_uint num_param,
                               const char** keys, const char** vals,
                               SymbolHandle* out) {
  API_ENTER();
  PyObject* r = call_api(
      "symbol_create_atomic",
      Py_BuildValue("(ONN)", unbox(creator), str_list(keys, num_param),
                    str_list(vals, num_param)));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXSymbolCreateVariable(const char* name, SymbolHandle* out) {
  API_ENTER();
  PyObject* r = call_api("symbol_create_variable", Py_BuildValue("(s)", name));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle* symbols,
                        SymbolHandle* out) {
  API_ENTER();
  PyObject* r = call_api("symbol_create_group",
                         Py_BuildValue("(N)", handle_list(symbols, num_symbols)));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXSymbolCreateFromFile(const char* fname, SymbolHandle* out) {
  API_ENTER();
  PyObject* r = call_api("symbol_from_file", Py_BuildValue("(s)", fname));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXSymbolCreateFromJSON(const char* json, SymbolHandle* out) {
  API_ENTER();
  PyObject* r = call_api("symbol_from_json", Py_BuildValue("(s)", json));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXSymbolSaveToFile(SymbolHandle symbol, const char* fname) {
  API_ENTER();
  PyObject* r = call_api("symbol_save_file",
                         Py_BuildValue("(Os)", unbox(symbol), fname));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXSymbolSaveToJSON(SymbolHandle symbol, const char** out_json) {
  API_ENTER();
  PyObject* r = call_api("symbol_to_json", Py_BuildValue("(O)", unbox(symbol)));
  if (!r) return fail();
  tls_scratch.blob = PyUnicode_AsUTF8(r);
  Py_DECREF(r);
  *out_json = tls_scratch.blob.c_str();
  return 0;
}

int MXSymbolFree(SymbolHandle symbol) { return MXNDArrayFree(symbol); }

int MXSymbolCopy(SymbolHandle symbol, SymbolHandle* out) {
  API_ENTER();
  PyObject* r = call_api("symbol_copy", Py_BuildValue("(O)", unbox(symbol)));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXSymbolPrint(SymbolHandle symbol, const char** out_str) {
  API_ENTER();
  PyObject* r = call_api("symbol_print", Py_BuildValue("(O)", unbox(symbol)));
  if (!r) return fail();
  tls_scratch.blob = PyUnicode_AsUTF8(r);
  Py_DECREF(r);
  *out_str = tls_scratch.blob.c_str();
  return 0;
}

static int list_strings_api(const char* method, SymbolHandle symbol,
                            mx_uint* out_size, const char*** out_str_array) {
  PyObject* r = call_api(method, Py_BuildValue("(O)", unbox(symbol)));
  if (!r) return fail();
  *out_str_array = to_cstr_array(r, out_size, &tls_scratch.cstrs);
  Py_DECREF(r);
  return 0;
}

int MXSymbolListArguments(SymbolHandle symbol, mx_uint* out_size,
                          const char*** out_str_array) {
  API_ENTER();
  return list_strings_api("symbol_list_arguments", symbol, out_size,
                          out_str_array);
}

int MXSymbolListOutputs(SymbolHandle symbol, mx_uint* out_size,
                        const char*** out_str_array) {
  API_ENTER();
  return list_strings_api("symbol_list_outputs", symbol, out_size,
                          out_str_array);
}

int MXSymbolListAuxiliaryStates(SymbolHandle symbol, mx_uint* out_size,
                                const char*** out_str_array) {
  API_ENTER();
  return list_strings_api("symbol_list_aux", symbol, out_size, out_str_array);
}

int MXSymbolGetInternals(SymbolHandle symbol, SymbolHandle* out) {
  API_ENTER();
  PyObject* r = call_api("symbol_get_internals",
                         Py_BuildValue("(O)", unbox(symbol)));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXSymbolGetOutput(SymbolHandle symbol, mx_uint index, SymbolHandle* out) {
  API_ENTER();
  PyObject* r = call_api("symbol_get_output",
                         Py_BuildValue("(OI)", unbox(symbol), index));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXSymbolCompose(SymbolHandle sym, const char* name, mx_uint num_args,
                    const char** keys, SymbolHandle* args) {
  API_ENTER();
  PyObject* keylist = keys ? str_list(keys, num_args) : PyList_New(0);
  PyObject* r = call_api(
      "symbol_compose",
      Py_BuildValue("(OsNN)", unbox(sym), name ? name : "", keylist,
                    handle_list(args, num_args)));
  if (!r) return fail();
  // reference semantics: compose mutates the symbol behind the handle
  Box* b = static_cast<Box*>(sym);
  Py_XDECREF(b->obj);
  b->obj = r;
  return 0;
}

int MXSymbolGrad(SymbolHandle sym, mx_uint num_wrt, const char** wrt,
                 SymbolHandle* out) {
  API_ENTER();
  (void)sym;
  (void)num_wrt;
  (void)wrt;
  (void)out;
  tls_error =
      "MXSymbolGrad: explicit gradient graphs are not materialized "
      "(autograd runs inside the executor; use MXExecutorBackward)";
  return -1;
}

int MXSymbolInferShape(SymbolHandle sym, mx_uint num_args, const char** keys,
                       const mx_uint* arg_ind_ptr, const mx_uint* arg_shape_data,
                       mx_uint* in_shape_size, const mx_uint** in_shape_ndim,
                       const mx_uint*** in_shape_data, mx_uint* out_shape_size,
                       const mx_uint** out_shape_ndim,
                       const mx_uint*** out_shape_data, mx_uint* aux_shape_size,
                       const mx_uint** aux_shape_ndim,
                       const mx_uint*** aux_shape_data, int* complete) {
  API_ENTER();
  PyObject* shapes = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    mx_uint lo = arg_ind_ptr[i], hi = arg_ind_ptr[i + 1];
    PyObject* s = PyTuple_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyTuple_SET_ITEM(s, j - lo, PyLong_FromUnsignedLong(arg_shape_data[j]));
    PyList_SET_ITEM(shapes, i, s);
  }
  PyObject* r = call_api(
      "symbol_infer_shape",
      Py_BuildValue("(ONN)", unbox(sym), str_list(keys, num_args), shapes));
  if (!r) return fail();
  PyObject *argl, *outl, *auxl;
  int comp;
  if (!PyArg_ParseTuple(r, "OOOi", &argl, &outl, &auxl, &comp)) {
    Py_DECREF(r);
    return fail();
  }
  PyObject* lists[3] = {argl, outl, auxl};
  mx_uint* sizes[3] = {in_shape_size, out_shape_size, aux_shape_size};
  const mx_uint** ndims[3] = {in_shape_ndim, out_shape_ndim, aux_shape_ndim};
  const mx_uint*** datas[3] = {in_shape_data, out_shape_data, aux_shape_data};
  tls_scratch.shape_store.clear();
  for (int g = 0; g < 3; ++g) {
    Py_ssize_t n = PyList_Size(lists[g]);
    tls_scratch.shape_ndim[g].clear();
    tls_scratch.shape_ptrs[g].clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* s = PyList_GetItem(lists[g], i);
      Py_ssize_t d = PyTuple_Size(s);
      std::vector<mx_uint> dims;
      for (Py_ssize_t j = 0; j < d; ++j)
        dims.push_back((mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(s, j)));
      tls_scratch.shape_store.push_back(std::move(dims));
      tls_scratch.shape_ndim[g].push_back((mx_uint)d);
    }
    *sizes[g] = static_cast<mx_uint>(n);
  }
  // pointers into shape_store are stable now (no more push_back)
  size_t idx = 0;
  for (int g = 0; g < 3; ++g) {
    for (size_t i = 0; i < tls_scratch.shape_ndim[g].size(); ++i)
      tls_scratch.shape_ptrs[g].push_back(tls_scratch.shape_store[idx++].data());
    *ndims[g] = tls_scratch.shape_ndim[g].data();
    *datas[g] = tls_scratch.shape_ptrs[g].data();
  }
  *complete = comp;
  Py_DECREF(r);
  return 0;
}

/* ------------------------------------------------------------ executor */

int MXExecutorFree(ExecutorHandle handle) { return MXNDArrayFree(handle); }

int MXExecutorPrint(ExecutorHandle handle, const char** out_str) {
  API_ENTER();
  PyObject* r = call_api("executor_print", Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  tls_scratch.blob = PyUnicode_AsUTF8(r);
  Py_DECREF(r);
  *out_str = tls_scratch.blob.c_str();
  return 0;
}

int MXExecutorForward(ExecutorHandle handle, int is_train) {
  API_ENTER();
  PyObject* r = call_api("executor_forward",
                         Py_BuildValue("(Oi)", unbox(handle), is_train));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXExecutorBackward(ExecutorHandle handle, mx_uint len,
                       NDArrayHandle* head_grads) {
  API_ENTER();
  PyObject* r = call_api(
      "executor_backward",
      Py_BuildValue("(ON)", unbox(handle), handle_list(head_grads, len)));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXExecutorOutputs(ExecutorHandle handle, mx_uint* out_size,
                      NDArrayHandle** out) {
  API_ENTER();
  PyObject* r = call_api("executor_outputs",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  Py_ssize_t n = PyList_Size(r);
  tls_scratch.handles.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* o = PyList_GetItem(r, i);
    Py_INCREF(o);
    tls_scratch.handles.push_back(make_box(o));
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out = tls_scratch.handles.data();
  return 0;
}

int MXExecutorBind(SymbolHandle symbol_handle, int dev_type, int dev_id,
                   mx_uint len, NDArrayHandle* in_args,
                   NDArrayHandle* arg_grad_store, mx_uint* grad_req_type,
                   mx_uint aux_states_len, NDArrayHandle* aux_states,
                   ExecutorHandle* out) {
  API_ENTER();
  PyObject* reqs = PyList_New(len);
  for (mx_uint i = 0; i < len; ++i)
    PyList_SET_ITEM(reqs, i, PyLong_FromUnsignedLong(grad_req_type[i]));
  PyObject* grads = PyList_New(len);
  for (mx_uint i = 0; i < len; ++i) {
    PyObject* g = (arg_grad_store && arg_grad_store[i])
                      ? unbox(arg_grad_store[i]) : Py_None;
    Py_INCREF(g);
    PyList_SET_ITEM(grads, i, g);
  }
  PyObject* r = call_api(
      "executor_bind",
      Py_BuildValue("(OiiNNNN)", unbox(symbol_handle), dev_type, dev_id,
                    handle_list(in_args, len), grads, reqs,
                    handle_list(aux_states, aux_states_len)));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

/* ------------------------------------------------------------------ io */

int MXListDataIters(mx_uint* out_size, DataIterCreator** out_array) {
  API_ENTER();
  PyObject* r = call_api("list_data_iters", PyTuple_New(0));
  if (!r) return fail();
  Py_ssize_t n = PyList_Size(r);
  tls_scratch.handles.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* name = PyList_GetItem(r, i);
    Py_INCREF(name);
    tls_scratch.handles.push_back(make_box(name));
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out_array = tls_scratch.handles.data();
  return 0;
}

int MXDataIterCreateIter(DataIterCreator handle, mx_uint num_param,
                         const char** keys, const char** vals,
                         DataIterHandle* out) {
  API_ENTER();
  PyObject* r = call_api(
      "data_iter_create",
      Py_BuildValue("(ONN)", unbox(handle), str_list(keys, num_param),
                    str_list(vals, num_param)));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXDataIterGetIterInfo(DataIterCreator creator, const char** name,
                          const char** description, mx_uint* num_args,
                          const char*** arg_names,
                          const char*** arg_type_infos,
                          const char*** arg_descriptions) {
  API_ENTER();
  tls_scratch.blob = PyUnicode_AsUTF8(unbox(creator));
  *name = tls_scratch.blob.c_str();
  tls_scratch.strings.emplace_back("");
  *description = tls_scratch.strings.back().c_str();
  *num_args = 0;
  tls_scratch.cstrs.clear();
  *arg_names = tls_scratch.cstrs.data();
  *arg_type_infos = tls_scratch.cstrs.data();
  *arg_descriptions = tls_scratch.cstrs.data();
  return 0;
}

int MXDataIterFree(DataIterHandle handle) { return MXNDArrayFree(handle); }

int MXDataIterNext(DataIterHandle handle, int* out) {
  API_ENTER();
  PyObject* r = call_api("data_iter_next", Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

int MXDataIterBeforeFirst(DataIterHandle handle) {
  API_ENTER();
  PyObject* r = call_api("data_iter_before_first",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXDataIterGetData(DataIterHandle handle, NDArrayHandle* out) {
  API_ENTER();
  PyObject* r = call_api("data_iter_get_data",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXDataIterGetPadNum(DataIterHandle handle, int* pad) {
  API_ENTER();
  PyObject* r = call_api("data_iter_get_pad",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  *pad = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

int MXDataIterGetLabel(DataIterHandle handle, NDArrayHandle* out) {
  API_ENTER();
  PyObject* r = call_api("data_iter_get_label",
                         Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

/* ------------------------------------------------------------- kvstore */

int MXKVStoreCreate(const char* type, KVStoreHandle* out) {
  API_ENTER();
  PyObject* r = call_api("kv_create", Py_BuildValue("(s)", type));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXKVStoreFree(KVStoreHandle handle) { return MXNDArrayFree(handle); }

int MXKVStoreInit(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals) {
  API_ENTER();
  PyObject* r = call_api(
      "kv_init", Py_BuildValue("(ONN)", unbox(handle), int_list(keys, num),
                               handle_list(vals, num)));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXKVStorePush(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals, int priority) {
  API_ENTER();
  PyObject* r = call_api(
      "kv_push", Py_BuildValue("(ONNi)", unbox(handle), int_list(keys, num),
                               handle_list(vals, num), priority));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXKVStorePull(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals, int priority) {
  API_ENTER();
  PyObject* r = call_api(
      "kv_pull", Py_BuildValue("(ONNi)", unbox(handle), int_list(keys, num),
                               handle_list(vals, num), priority));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

namespace {
struct UpdaterCtx {
  MXKVStoreUpdater fn;
  void* handle;
};

PyObject* updater_trampoline(PyObject* self, PyObject* args) {
  UpdaterCtx* ctx = static_cast<UpdaterCtx*>(
      PyCapsule_GetPointer(self, "mxtpu_updater"));
  int key;
  PyObject *recv, *local;
  if (!PyArg_ParseTuple(args, "iOO", &key, &recv, &local)) return nullptr;
  Py_INCREF(recv);
  Py_INCREF(local);
  Box* hr = new Box{recv, nullptr};
  Box* hl = new Box{local, nullptr};
  ctx->fn(key, hr, hl, ctx->handle);
  MXNDArrayFree(hr);
  MXNDArrayFree(hl);
  Py_RETURN_NONE;
}

PyMethodDef updater_def = {"mxtpu_c_updater", updater_trampoline,
                           METH_VARARGS, nullptr};
}  // namespace

int MXKVStoreSetUpdater(KVStoreHandle handle, MXKVStoreUpdater updater,
                        void* updater_handle) {
  API_ENTER();
  UpdaterCtx* ctx = new UpdaterCtx{updater, updater_handle};  // lives forever
  PyObject* cap = PyCapsule_New(ctx, "mxtpu_updater", nullptr);
  PyObject* fn = PyCFunction_New(&updater_def, cap);
  Py_DECREF(cap);
  PyObject* r = call_api("kv_set_updater",
                         Py_BuildValue("(ON)", unbox(handle), fn));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXKVStoreGetType(KVStoreHandle handle, const char** type) {
  API_ENTER();
  PyObject* r = call_api("kv_get_type", Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  tls_scratch.blob = PyUnicode_AsUTF8(r);
  Py_DECREF(r);
  *type = tls_scratch.blob.c_str();
  return 0;
}

static int int_api(const char* method, KVStoreHandle handle, int* ret) {
  PyObject* r = handle
                    ? call_api(method, Py_BuildValue("(O)", unbox(handle)))
                    : call_api(method, PyTuple_New(0));
  if (!r) return fail();
  *ret = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

int MXKVStoreGetRank(KVStoreHandle handle, int* ret) {
  API_ENTER();
  return int_api("kv_get_rank", handle, ret);
}

int MXKVStoreGetGroupSize(KVStoreHandle handle, int* ret) {
  API_ENTER();
  return int_api("kv_get_group_size", handle, ret);
}

int MXKVStoreIsWorkerNode(int* ret) {
  API_ENTER();
  return int_api("kv_is_worker_node", nullptr, ret);
}

int MXKVStoreIsServerNode(int* ret) {
  API_ENTER();
  return int_api("kv_is_server_node", nullptr, ret);
}

int MXKVStoreIsSchedulerNode(int* ret) {
  API_ENTER();
  return int_api("kv_is_scheduler_node", nullptr, ret);
}

int MXKVStoreBarrier(KVStoreHandle handle) {
  API_ENTER();
  PyObject* r = call_api("kv_barrier", Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXKVStoreRunServer(KVStoreHandle handle,
                       MXKVStoreServerController controller,
                       void* controller_handle) {
  API_ENTER();
  (void)controller;
  (void)controller_handle;
  PyObject* r = call_api("kv_run_server",
                         Py_BuildValue("(OO)", unbox(handle), Py_None));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXKVStoreSendCommmandToServers(KVStoreHandle handle, int cmd_id,
                                   const char* cmd_body) {
  API_ENTER();
  PyObject* r = call_api(
      "kv_send_command",
      Py_BuildValue("(Ois)", unbox(handle), cmd_id, cmd_body));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

/* ------------------------------------------------------------ recordio */

int MXRecordIOWriterCreate(const char* uri, RecordIOHandle* out) {
  API_ENTER();
  PyObject* r = call_api("recordio_writer_create", Py_BuildValue("(s)", uri));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

static int recordio_free(RecordIOHandle handle) {
  if (handle == nullptr) return 0;
  if (ensure_api() != 0) return -1;
  Gil gil;
  PyObject* r = call_api("recordio_close", Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  Py_DECREF(r);
  Box* b = static_cast<Box*>(handle);
  if (b->obj != nullptr) last_box_released(b->obj);  // keep counts balanced
  Py_XDECREF(b->obj);
  Py_XDECREF(b->aux);
  delete b;
  return 0;
}

int MXRecordIOWriterFree(RecordIOHandle handle) {
  return recordio_free(handle);
}

int MXRecordIOWriterWriteRecord(RecordIOHandle handle, const char* buf,
                                size_t size) {
  API_ENTER();
  PyObject* r = call_api(
      "recordio_write",
      Py_BuildValue("(Oy#)", unbox(handle), buf, (Py_ssize_t)size));
  if (!r) return fail();
  Py_DECREF(r);
  return 0;
}

int MXRecordIOReaderCreate(const char* uri, RecordIOHandle* out) {
  API_ENTER();
  PyObject* r = call_api("recordio_reader_create", Py_BuildValue("(s)", uri));
  if (!r) return fail();
  *out = make_box(r);
  return 0;
}

int MXRecordIOReaderFree(RecordIOHandle handle) {
  return recordio_free(handle);
}

int MXRecordIOReaderReadRecord(RecordIOHandle handle, const char** buf,
                               size_t* size) {
  API_ENTER();
  PyObject* r = call_api("recordio_read", Py_BuildValue("(O)", unbox(handle)));
  if (!r) return fail();
  Box* b = static_cast<Box*>(handle);
  Py_XDECREF(b->aux);
  b->aux = r;  // keep the bytes alive on the handle
  char* data;
  Py_ssize_t len;
  if (PyBytes_AsStringAndSize(r, &data, &len) != 0) return fail();
  *buf = len ? data : nullptr;
  *size = (size_t)len;
  return 0;
}

}  // extern "C"
