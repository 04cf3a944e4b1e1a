/*
 * Flat C API for mxnet_tpu_torch, the copy of the JAX package's
 * native/mxtpu_c_api.h — reference parity: include/mxnet/c_api.h (this
 * header covers all 79 `int MX*` functions the reference snapshot exports,
 * same names and argument conventions).
 *
 * Implementation note (the one deliberate divergence): the reference's C
 * API fronts a C++ core; this framework's core is PyTorch/Python, so
 * libmxtpu_torch_capi embeds CPython and forwards into
 * mxnet_tpu_torch/capi_support.py. dev_type: 1 cpu, 2 gpu (the card),
 * 3 cpu_pinned. Handles are opaque boxes owning one Python
 * reference; every function returns 0 on success, -1 on failure with the
 * message available from MXGetLastError() (thread-local, like
 * src/c_api/c_api_error.h).
 *
 * Consumers: the R training binding (bindings/r/) and any embedder that
 * would have linked libmxnet. Link: -lmxtpu_torch_capi from the directory
 * mxnet_tpu_torch.native.capi.build_capi() returns the library in; the
 * library itself links the Python runtime.
 */
#ifndef MXTPU_C_API_H_
#define MXTPU_C_API_H_

#ifdef __cplusplus
extern "C" {
#endif

#include <stddef.h>
#include <stdint.h>

typedef unsigned int mx_uint;
typedef float mx_float;

typedef void *NDArrayHandle;
typedef const void *FunctionHandle;
typedef void *AtomicSymbolCreator;
typedef void *SymbolHandle;
typedef void *AtomicSymbolHandle;
typedef void *ExecutorHandle;
typedef void *DataIterCreator;
typedef void *DataIterHandle;
typedef void *KVStoreHandle;
typedef void *RecordIOHandle;

const char *MXGetLastError();

/* ------------------------------------------------------------- ndarray */
int MXRandomSeed(int seed);
int MXNotifyShutdown();
int MXNDArrayCreateNone(NDArrayHandle *out);
int MXNDArrayCreate(const mx_uint *shape, mx_uint ndim, int dev_type,
                    int dev_id, int delay_alloc, NDArrayHandle *out);
int MXNDArrayLoadFromRawBytes(const void *buf, size_t size,
                              NDArrayHandle *out);
int MXNDArraySaveRawBytes(NDArrayHandle handle, size_t *out_size,
                          const char **out_buf);
int MXNDArraySave(const char *fname, mx_uint num_args, NDArrayHandle *args,
                  const char **keys);
int MXNDArrayLoad(const char *fname, mx_uint *out_size,
                  NDArrayHandle **out_arr, mx_uint *out_name_size,
                  const char ***out_names);
int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const mx_float *data,
                             size_t size);
int MXNDArraySyncCopyToCPU(NDArrayHandle handle, mx_float *data, size_t size);
int MXNDArrayWaitToRead(NDArrayHandle handle);
int MXNDArrayWaitToWrite(NDArrayHandle handle);
int MXNDArrayWaitAll();
int MXNDArrayFree(NDArrayHandle handle);
int MXNDArraySlice(NDArrayHandle handle, mx_uint slice_begin,
                   mx_uint slice_end, NDArrayHandle *out);
int MXNDArrayGetShape(NDArrayHandle handle, mx_uint *out_dim,
                      const mx_uint **out_pdata);
/* READ-ONLY in this build: the pointer is a host mirror of the array (a
 * copy from the card for an array there), refreshed on every call and kept
 * alive until the last handle boxing the array is freed. Writes through it
 * do NOT propagate to the array (unlike the reference's
 * pointer-into-live-CPU-tensor); use MXNDArraySyncCopyFromCPU to mutate. */
int MXNDArrayGetData(NDArrayHandle handle, mx_float **out_pdata);
int MXNDArrayGetContext(NDArrayHandle handle, int *out_dev_type,
                        int *out_dev_id);

/* ----------------------------------------------------------- functions */
int MXListFunctions(mx_uint *out_size, FunctionHandle **out_array);
int MXGetFunction(const char *name, FunctionHandle *out);
int MXFuncGetInfo(FunctionHandle fun, const char **name,
                  const char **description, mx_uint *num_args,
                  const char ***arg_names, const char ***arg_type_infos,
                  const char ***arg_descriptions);
int MXFuncDescribe(FunctionHandle fun, mx_uint *num_use_vars,
                   mx_uint *num_scalars, mx_uint *num_mutate_vars,
                   int *type_mask);
int MXFuncInvoke(FunctionHandle fun, NDArrayHandle *use_vars,
                 mx_float *scalar_args, NDArrayHandle *mutate_vars);

/* ------------------------------------------------------------- symbols */
int MXSymbolListAtomicSymbolCreators(mx_uint *out_size,
                                     AtomicSymbolCreator **out_array);
int MXSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator,
                                const char **name, const char **description,
                                mx_uint *num_args, const char ***arg_names,
                                const char ***arg_type_infos,
                                const char ***arg_descriptions,
                                const char **key_var_num_args);
int MXSymbolCreateAtomicSymbol(AtomicSymbolCreator creator, mx_uint num_param,
                               const char **keys, const char **vals,
                               SymbolHandle *out);
int MXSymbolCreateVariable(const char *name, SymbolHandle *out);
int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle *symbols,
                        SymbolHandle *out);
int MXSymbolCreateFromFile(const char *fname, SymbolHandle *out);
int MXSymbolCreateFromJSON(const char *json, SymbolHandle *out);
int MXSymbolSaveToFile(SymbolHandle symbol, const char *fname);
int MXSymbolSaveToJSON(SymbolHandle symbol, const char **out_json);
int MXSymbolFree(SymbolHandle symbol);
int MXSymbolCopy(SymbolHandle symbol, SymbolHandle *out);
int MXSymbolPrint(SymbolHandle symbol, const char **out_str);
int MXSymbolListArguments(SymbolHandle symbol, mx_uint *out_size,
                          const char ***out_str_array);
int MXSymbolListOutputs(SymbolHandle symbol, mx_uint *out_size,
                        const char ***out_str_array);
int MXSymbolGetInternals(SymbolHandle symbol, SymbolHandle *out);
int MXSymbolGetOutput(SymbolHandle symbol, mx_uint index, SymbolHandle *out);
int MXSymbolListAuxiliaryStates(SymbolHandle symbol, mx_uint *out_size,
                                const char ***out_str_array);
int MXSymbolCompose(SymbolHandle sym, const char *name, mx_uint num_args,
                    const char **keys, SymbolHandle *args);
int MXSymbolGrad(SymbolHandle sym, mx_uint num_wrt, const char **wrt,
                 SymbolHandle *out);
int MXSymbolInferShape(SymbolHandle sym, mx_uint num_args, const char **keys,
                       const mx_uint *arg_ind_ptr, const mx_uint *arg_shape_data,
                       mx_uint *in_shape_size, const mx_uint **in_shape_ndim,
                       const mx_uint ***in_shape_data, mx_uint *out_shape_size,
                       const mx_uint **out_shape_ndim,
                       const mx_uint ***out_shape_data, mx_uint *aux_shape_size,
                       const mx_uint **aux_shape_ndim,
                       const mx_uint ***aux_shape_data, int *complete);

/* ------------------------------------------------------------ executor */
int MXExecutorFree(ExecutorHandle handle);
int MXExecutorPrint(ExecutorHandle handle, const char **out_str);
int MXExecutorForward(ExecutorHandle handle, int is_train);
int MXExecutorBackward(ExecutorHandle handle, mx_uint len,
                       NDArrayHandle *head_grads);
int MXExecutorOutputs(ExecutorHandle handle, mx_uint *out_size,
                      NDArrayHandle **out);
int MXExecutorBind(SymbolHandle symbol_handle, int dev_type, int dev_id,
                   mx_uint len, NDArrayHandle *in_args,
                   NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                   mx_uint aux_states_len, NDArrayHandle *aux_states,
                   ExecutorHandle *out);

/* ------------------------------------------------------------------ io */
int MXListDataIters(mx_uint *out_size, DataIterCreator **out_array);
int MXDataIterCreateIter(DataIterCreator handle, mx_uint num_param,
                         const char **keys, const char **vals,
                         DataIterHandle *out);
int MXDataIterGetIterInfo(DataIterCreator creator, const char **name,
                          const char **description, mx_uint *num_args,
                          const char ***arg_names,
                          const char ***arg_type_infos,
                          const char ***arg_descriptions);
int MXDataIterFree(DataIterHandle handle);
int MXDataIterNext(DataIterHandle handle, int *out);
int MXDataIterBeforeFirst(DataIterHandle handle);
int MXDataIterGetData(DataIterHandle handle, NDArrayHandle *out);
int MXDataIterGetPadNum(DataIterHandle handle, int *pad);
int MXDataIterGetLabel(DataIterHandle handle, NDArrayHandle *out);

/* ------------------------------------------------------------- kvstore */
typedef void (*MXKVStoreUpdater)(int key, NDArrayHandle recv,
                                 NDArrayHandle local, void *handle);
typedef void (*MXKVStoreServerController)(int head, const char *body,
                                          void *controller_handle);

int MXKVStoreCreate(const char *type, KVStoreHandle *out);
int MXKVStoreFree(KVStoreHandle handle);
int MXKVStoreInit(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals);
int MXKVStorePush(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals, int priority);
int MXKVStorePull(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals, int priority);
int MXKVStoreSetUpdater(KVStoreHandle handle, MXKVStoreUpdater updater,
                        void *updater_handle);
int MXKVStoreGetType(KVStoreHandle handle, const char **type);
int MXKVStoreGetRank(KVStoreHandle handle, int *ret);
int MXKVStoreGetGroupSize(KVStoreHandle handle, int *ret);
int MXKVStoreIsWorkerNode(int *ret);
int MXKVStoreIsServerNode(int *ret);
int MXKVStoreIsSchedulerNode(int *ret);
int MXKVStoreBarrier(KVStoreHandle handle);
int MXKVStoreRunServer(KVStoreHandle handle,
                       MXKVStoreServerController controller,
                       void *controller_handle);
/* reference spells it with three m's (c_api.h:860) — kept verbatim */
int MXKVStoreSendCommmandToServers(KVStoreHandle handle, int cmd_id,
                                   const char *cmd_body);

/* ------------------------------------------------------------ recordio */
int MXRecordIOWriterCreate(const char *uri, RecordIOHandle *out);
int MXRecordIOWriterFree(RecordIOHandle handle);
int MXRecordIOWriterWriteRecord(RecordIOHandle handle, const char *buf,
                                size_t size);
int MXRecordIOReaderCreate(const char *uri, RecordIOHandle *out);
int MXRecordIOReaderFree(RecordIOHandle handle);
int MXRecordIOReaderReadRecord(RecordIOHandle handle, const char **buf,
                               size_t *size);

#ifdef __cplusplus
}
#endif

#endif /* MXTPU_C_API_H_ */
