// R training shim: .C-convention wrappers over the port's flat C API
// (mxnet_tpu_torch/native/mxtpu_c_api.h). Copy of R-package/src/
// mxtpu_r_train.cc bound to libmxtpu_torch_capi.so; arrays and executors
// stay on dev_type 1 (cpu), as in the JAX package's shim.
//
// Reference counterpart: R-package/src/*.cc (Rcpp bindings over
// include/mxnet/c_api.h). R's .C interface passes everything as pointers
// to basic types and copies vectors, so handles cross as integer ids into
// a process-local table, strings as char**, and tensors as double* (R has
// no float; converted at the boundary).
//
// Build: the library first (python -c "from mxnet_tpu_torch.native.capi
// import build_capi; print(build_capi())" prints its path, in a
// directory DIR), then
//   g++ -O2 -std=c++17 -fPIC -shared mxtpu_r_train.cc -o libmxtpu_r_train.so
//       -LDIR -lmxtpu_torch_capi -Wl,-rpath,DIR
// The same entry points are also exercised without R by
// tests/test_torch_r_binding.py through ctypes using the identical
// pointer calling convention.

#include <cstring>
#include <map>
#include <string>
#include <vector>

#include "../../native/mxtpu_c_api.h"

namespace {

std::map<int, void*> g_handles;
int g_next_id = 1;
std::string g_last_error;

int put_handle(void* h) {
  int id = g_next_id++;
  g_handles[id] = h;
  return id;
}

void* get_handle(int id) {
  auto it = g_handles.find(id);
  return it == g_handles.end() ? nullptr : it->second;
}

int record(int rc) {
  if (rc != 0) g_last_error = MXGetLastError();
  return rc;
}

}  // namespace

extern "C" {

void mxr_last_error(char** msg, int* len) {
  std::strncpy(*msg, g_last_error.c_str(), *len - 1);
  (*msg)[*len - 1] = '\0';
}

void mxr_random_seed(int* seed, int* status) {
  *status = record(MXRandomSeed(*seed));
}

/* ------------------------------------------------------------- ndarray */

void mxr_nd_create(int* shape, int* ndim, int* id_out, int* status) {
  std::vector<mx_uint> s(shape, shape + *ndim);
  NDArrayHandle h;
  *status = record(MXNDArrayCreate(s.data(), *ndim, 1, 0, 0, &h));
  if (*status == 0) *id_out = put_handle(h);
}

void mxr_nd_free(int* id, int* status) {
  void* h = get_handle(*id);
  g_handles.erase(*id);
  *status = record(MXNDArrayFree(h));
}

void mxr_nd_shape(int* id, int* ndim_out, int* shape_out, int* status) {
  mx_uint nd;
  const mx_uint* dims;
  *status = record(MXNDArrayGetShape(get_handle(*id), &nd, &dims));
  if (*status != 0) return;
  if (nd > 8) {
    // the R caller indexes seq_len(ndim) into integer(8); reporting the
    // full ndim with a truncated copy would hand it NA dims — fail loudly
    // instead (same capacity contract as mxr_sym_infer_shapes)
    g_last_error = "mxr_nd_shape: array has more than 8 dimensions";
    *status = -1;
    return;
  }
  *ndim_out = (int)nd;
  for (mx_uint i = 0; i < nd; ++i) shape_out[i] = (int)dims[i];
}

void mxr_nd_set(int* id, double* data, int* n, int* status) {
  std::vector<float> buf(*n);
  for (int i = 0; i < *n; ++i) buf[i] = (float)data[i];
  *status = record(
      MXNDArraySyncCopyFromCPU(get_handle(*id), buf.data(), *n));
}

void mxr_nd_get(int* id, double* data, int* n, int* status) {
  std::vector<float> buf(*n);
  *status = record(MXNDArraySyncCopyToCPU(get_handle(*id), buf.data(), *n));
  if (*status != 0) return;
  for (int i = 0; i < *n; ++i) data[i] = buf[i];
}

/* ------------------------------------------------------------- symbols */

void mxr_sym_variable(char** name, int* id_out, int* status) {
  SymbolHandle h;
  *status = record(MXSymbolCreateVariable(name[0], &h));
  if (*status == 0) *id_out = put_handle(h);
}

void mxr_sym_atomic(char** opname, int* nparam, char** keys, char** vals,
                    int* id_out, int* status) {
  // enumerate the registry once and cache name -> creator: creator handles
  // from MXSymbolListAtomicSymbolCreators are owned allocations, so
  // re-listing per symbol would both leak them and cost O(#ops) embedded
  // Python round-trips for every layer an R model builds
  static std::map<std::string, AtomicSymbolCreator> creator_cache;
  if (creator_cache.empty()) {
    mx_uint n_creators;
    AtomicSymbolCreator* creators;
    *status = record(MXSymbolListAtomicSymbolCreators(&n_creators,
                                                      &creators));
    if (*status != 0) return;
    for (mx_uint i = 0; i < n_creators; ++i) {
      const char *nm, *desc, *kv;
      mx_uint na;
      const char **an, **at, **ad;
      if (MXSymbolGetAtomicSymbolInfo(creators[i], &nm, &desc, &na, &an,
                                      &at, &ad, &kv) != 0)
        continue;
      creator_cache[nm] = creators[i];
    }
  }
  auto it = creator_cache.find(opname[0]);
  if (it == creator_cache.end()) {
    g_last_error = std::string("unknown operator ") + opname[0];
    *status = -1;
    return;
  }
  AtomicSymbolCreator target = it->second;
  std::vector<const char*> k(*nparam), v(*nparam);
  for (int i = 0; i < *nparam; ++i) {
    k[i] = keys[i];
    v[i] = vals[i];
  }
  SymbolHandle h;
  *status = record(MXSymbolCreateAtomicSymbol(target, *nparam, k.data(),
                                              v.data(), &h));
  if (*status == 0) *id_out = put_handle(h);
}

void mxr_sym_compose(int* sym_id, char** name, int* nargs, char** keys,
                     int* arg_ids, int* status) {
  std::vector<const char*> k(*nargs);
  std::vector<SymbolHandle> args(*nargs);
  for (int i = 0; i < *nargs; ++i) {
    k[i] = keys[i];
    args[i] = get_handle(arg_ids[i]);
  }
  *status = record(MXSymbolCompose(get_handle(*sym_id), name[0], *nargs,
                                   k.data(), args.data()));
}

// joined with '\n' into the caller's buffer (R-friendly string return)
static void join_list(mx_uint n, const char** arr, char** out, int* cap) {
  std::string joined;
  for (mx_uint i = 0; i < n; ++i) {
    if (i) joined += '\n';
    joined += arr[i];
  }
  std::strncpy(*out, joined.c_str(), *cap - 1);
  (*out)[*cap - 1] = '\0';
}

void mxr_sym_arguments(int* id, char** out, int* cap, int* status) {
  mx_uint n;
  const char** names;
  *status = record(MXSymbolListArguments(get_handle(*id), &n, &names));
  if (*status == 0) join_list(n, names, out, cap);
}

void mxr_sym_aux(int* id, char** out, int* cap, int* status) {
  mx_uint n;
  const char** names;
  *status =
      record(MXSymbolListAuxiliaryStates(get_handle(*id), &n, &names));
  if (*status == 0) join_list(n, names, out, cap);
}

void mxr_sym_tojson(int* id, char** out, int* cap, int* status) {
  const char* js;
  *status = record(MXSymbolSaveToJSON(get_handle(*id), &js));
  if (*status != 0) return;
  std::strncpy(*out, js, *cap - 1);
  (*out)[*cap - 1] = '\0';
}

void mxr_sym_fromjson(char** js, int* id_out, int* status) {
  SymbolHandle h;
  *status = record(MXSymbolCreateFromJSON(js[0], &h));
  if (*status == 0) *id_out = put_handle(h);
}

// infer shapes given data shape; writes ndim+dims per argument
// (flattened, 8 slots per arg) and the same for aux states. `cap` is the
// number of per-argument slots the R caller allocated; exceeding it is an
// error, never an out-of-bounds write.
void mxr_sym_infer_shapes(int* id, char** data_name, int* data_shape,
                          int* data_ndim, int* cap, int* n_args_out,
                          int* arg_ndims, int* arg_shapes, int* n_aux_out,
                          int* aux_ndims, int* aux_shapes, int* status) {
  const char* keys[1] = {data_name[0]};
  mx_uint ind[2] = {0, (mx_uint)*data_ndim};
  std::vector<mx_uint> shp(*data_ndim);
  for (int i = 0; i < *data_ndim; ++i) shp[i] = data_shape[i];
  mx_uint in_n, out_n, aux_n;
  const mx_uint *in_nd, *out_nd, *aux_nd;
  const mx_uint **in_d, **out_d, **aux_d;
  int complete;
  *status = record(MXSymbolInferShape(
      get_handle(*id), 1, keys, ind, shp.data(), &in_n, &in_nd, &in_d,
      &out_n, &out_nd, &out_d, &aux_n, &aux_nd, &aux_d, &complete));
  if (*status != 0) return;
  if ((int)in_n > *cap || (int)aux_n > *cap) {
    g_last_error = "infer_shapes: symbol has more arguments than the "
                   "caller-provided capacity; raise max_args in "
                   "mx.symbol.infer.shapes";
    *status = -1;
    return;
  }
  *n_args_out = (int)in_n;
  for (mx_uint i = 0; i < in_n; ++i) {
    arg_ndims[i] = (int)in_nd[i];
    for (mx_uint j = 0; j < in_nd[i] && j < 8; ++j)
      arg_shapes[i * 8 + j] = (int)in_d[i][j];
  }
  *n_aux_out = (int)aux_n;
  for (mx_uint i = 0; i < aux_n; ++i) {
    aux_ndims[i] = (int)aux_nd[i];
    for (mx_uint j = 0; j < aux_nd[i] && j < 8; ++j)
      aux_shapes[i * 8 + j] = (int)aux_d[i][j];
  }
}

/* --------------------------------------------- checkpoint (nd save/load) */

// save named arrays to `fname` in the framework's checkpoint container —
// the SAME file format Python's mx.nd.save / model save_checkpoint writes,
// so R-side mx.model.save round-trips with Python FeedForward.load
// (reference capability: R-package/R/model.R mx.model.save -> mx.nd.save).
void mxr_nd_save(char** fname, int* n, int* ids, char** names,
                 int* status) {
  std::vector<NDArrayHandle> hs(*n);
  std::vector<const char*> ks(*n);
  for (int i = 0; i < *n; ++i) {
    hs[i] = get_handle(ids[i]);
    ks[i] = names[i];
  }
  *status = record(
      MXNDArraySave(fname[0], (mx_uint)*n, hs.data(), ks.data()));
}

// load a checkpoint container: ids into ids_out, names '\n'-joined into
// the caller's buffer (cap = id slots; name_cap = name buffer bytes)
void mxr_nd_load(char** fname, int* cap, int* n_out, int* ids_out,
                 char** names_out, int* name_cap, int* status) {
  mx_uint n, n_names;
  NDArrayHandle* hs;
  const char** names;
  *status = record(MXNDArrayLoad(fname[0], &n, &hs, &n_names, &names));
  if (*status != 0) return;
  if ((int)n > *cap || n_names != n) {
    for (mx_uint i = 0; i < n; ++i) MXNDArrayFree(hs[i]);
    g_last_error = "mxr_nd_load: more arrays than caller capacity (or "
                   "unnamed entries; R checkpoints are always named)";
    *status = -1;
    return;
  }
  std::string joined;
  for (mx_uint i = 0; i < n; ++i) {
    if (i) joined += '\n';
    joined += names[i];
  }
  if ((int)joined.size() >= *name_cap) {
    // truncating mid-name would hand R fewer/corrupt names than ids —
    // a silently mis-keyed model load; fail loudly instead (nothing was
    // registered yet, so no handle-table entries leak; the arrays
    // themselves are freed here)
    for (mx_uint i = 0; i < n; ++i) MXNDArrayFree(hs[i]);
    g_last_error = "mxr_nd_load: joined parameter names exceed the "
                   "caller-provided name buffer; raise name_cap in "
                   "mx.nd.load";
    *status = -1;
    return;
  }
  *n_out = (int)n;
  for (mx_uint i = 0; i < n; ++i) ids_out[i] = put_handle(hs[i]);
  std::strncpy(*names_out, joined.c_str(), *name_cap - 1);
  (*names_out)[*name_cap - 1] = '\0';
}

/* ------------------------------------- function registry (ndarray math) */

// invoke a registered NDArray function (MXFuncInvoke) — this is how the R
// optimizer layer runs its update math INSIDE the framework (XLA ops on
// runtime-resident arrays) instead of on R doubles, mirroring the
// reference's R optimizer over mx.nd arithmetic
// (reference: R-package/R/optimizer.R update() on mx.nd ops).
void mxr_func_invoke(char** fname, int* n_use, int* use_ids, int* n_scalar,
                     double* scalars, int* n_mutate, int* mutate_ids,
                     int* status) {
  FunctionHandle f;
  *status = record(MXGetFunction(fname[0], &f));
  if (*status != 0) return;
  std::vector<NDArrayHandle> use(*n_use), mut(*n_mutate);
  for (int i = 0; i < *n_use; ++i) use[i] = get_handle(use_ids[i]);
  for (int i = 0; i < *n_mutate; ++i) mut[i] = get_handle(mutate_ids[i]);
  std::vector<mx_float> sc(*n_scalar);
  for (int i = 0; i < *n_scalar; ++i) sc[i] = (mx_float)scalars[i];
  *status = record(MXFuncInvoke(f, use.data(), sc.data(), mut.data()));
}

/* -------------------------------------------------------------- kvstore */

void mxr_kv_create(char** type, int* id_out, int* status) {
  KVStoreHandle h;
  *status = record(MXKVStoreCreate(type[0], &h));
  if (*status == 0) *id_out = put_handle(h);
}

void mxr_kv_free(int* id, int* status) {
  void* h = get_handle(*id);
  g_handles.erase(*id);
  *status = record(MXKVStoreFree(h));
}

void mxr_kv_init(int* kv, int* n, int* keys, int* nd_ids, int* status) {
  std::vector<NDArrayHandle> vals(*n);
  for (int i = 0; i < *n; ++i) vals[i] = get_handle(nd_ids[i]);
  *status = record(
      MXKVStoreInit(get_handle(*kv), (mx_uint)*n, keys, vals.data()));
}

void mxr_kv_push(int* kv, int* n, int* keys, int* nd_ids, int* priority,
                 int* status) {
  std::vector<NDArrayHandle> vals(*n);
  for (int i = 0; i < *n; ++i) vals[i] = get_handle(nd_ids[i]);
  *status = record(MXKVStorePush(get_handle(*kv), (mx_uint)*n, keys,
                                 vals.data(), *priority));
}

void mxr_kv_pull(int* kv, int* n, int* keys, int* nd_ids, int* priority,
                 int* status) {
  std::vector<NDArrayHandle> vals(*n);
  for (int i = 0; i < *n; ++i) vals[i] = get_handle(nd_ids[i]);
  *status = record(MXKVStorePull(get_handle(*kv), (mx_uint)*n, keys,
                                 vals.data(), *priority));
}

void mxr_kv_rank(int* kv, int* rank_out, int* status) {
  *status = record(MXKVStoreGetRank(get_handle(*kv), rank_out));
}

void mxr_kv_size(int* kv, int* size_out, int* status) {
  *status = record(MXKVStoreGetGroupSize(get_handle(*kv), size_out));
}

void mxr_kv_barrier(int* kv, int* status) {
  *status = record(MXKVStoreBarrier(get_handle(*kv)));
}

/* ------------------------------------------------------------ executor */

void mxr_exec_bind(int* sym_id, int* n, int* arg_ids, int* grad_ids,
                   int* reqs, int* naux, int* aux_ids, int* id_out,
                   int* status) {
  std::vector<NDArrayHandle> args(*n), grads(*n), aux(*naux);
  std::vector<mx_uint> req(*n);
  for (int i = 0; i < *n; ++i) {
    args[i] = get_handle(arg_ids[i]);
    grads[i] = grad_ids[i] > 0 ? get_handle(grad_ids[i]) : nullptr;
    req[i] = (mx_uint)reqs[i];
  }
  for (int i = 0; i < *naux; ++i) aux[i] = get_handle(aux_ids[i]);
  ExecutorHandle h;
  *status = record(MXExecutorBind(get_handle(*sym_id), 1, 0, *n, args.data(),
                                  grads.data(), req.data(), *naux,
                                  aux.data(), &h));
  if (*status == 0) *id_out = put_handle(h);
}

void mxr_exec_forward(int* id, int* is_train, int* status) {
  *status = record(MXExecutorForward(get_handle(*id), *is_train));
}

void mxr_exec_backward(int* id, int* status) {
  *status = record(MXExecutorBackward(get_handle(*id), 0, nullptr));
}

void mxr_exec_outputs(int* id, int* ids_out, int* n_out, int* status) {
  mx_uint n;
  NDArrayHandle* outs;
  *status = record(MXExecutorOutputs(get_handle(*id), &n, &outs));
  if (*status != 0) return;
  if (n > 64) {  // R caller allocates 64 id slots
    g_last_error = "executor has more than 64 outputs";
    *status = -1;
    return;
  }
  *n_out = (int)n;
  for (mx_uint i = 0; i < n; ++i) ids_out[i] = put_handle(outs[i]);
}

}  // extern "C"
