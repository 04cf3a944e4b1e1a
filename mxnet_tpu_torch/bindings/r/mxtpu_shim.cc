// R .C-convention shim over the native predict ABI (mxtpu_predict.cc).
// Copy of R-package/src/mxtpu_shim.cc, compiled together with
// mxnet_tpu_torch/native/mxtpu_predict.cc.
//
// Reference counterpart: R-package/src/*.cc (Rcpp wrappers over the C API).
// This shim deliberately uses ONLY the .C calling convention (plain
// int*/double*/char** arguments, no R headers), so it compiles without an R
// installation and is testable from any FFI. Handles are kept in an
// id-indexed registry because .C cannot carry pointers.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

extern "C" {
// the native predict ABI (libmxtpu_predict.so)
void *mxtpu_pred_create(const char *bundle_path);
const char *mxtpu_pred_last_error(void);
int mxtpu_pred_set_input(void *h, const char *name, const float *data,
                         const int64_t *shape, int ndim);
int mxtpu_pred_forward(void *h);
int mxtpu_pred_num_outputs(void *h);
int mxtpu_pred_output_ndim(void *h, int index);
int mxtpu_pred_output_shape(void *h, int index, int64_t *shape);
int64_t mxtpu_pred_get_output(void *h, int index, float *out, int64_t size);
void mxtpu_pred_free(void *h);
}

namespace {
std::mutex g_mu;
std::map<int, void *> g_handles;
int g_next_id = 1;

void *get(int id) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_handles.find(id);
  return it == g_handles.end() ? nullptr : it->second;
}
}  // namespace

extern "C" {

// status: 0 ok, negative on error. R passes scalars as length-1 arrays.
void mxtpu_r_create(char **bundle_path, int *id_out, int *status) {
  void *h = mxtpu_pred_create(bundle_path[0]);
  if (h == nullptr) {
    *status = -1;
    *id_out = 0;
    return;
  }
  std::lock_guard<std::mutex> lock(g_mu);
  g_handles[g_next_id] = h;
  *id_out = g_next_id++;
  *status = 0;
}

void mxtpu_r_last_error(char **msg, int *len) {
  // copies into the caller-allocated buffer of *len bytes
  const char *err = mxtpu_pred_last_error();
  std::strncpy(msg[0], err, *len - 1);
  msg[0][*len - 1] = '\0';
}

void mxtpu_r_set_input(int *id, char **name, double *data, int *shape,
                       int *ndim, int *status) {
  void *h = get(*id);
  if (h == nullptr) { *status = -2; return; }
  int64_t total = 1;
  std::vector<int64_t> shp(*ndim);
  for (int i = 0; i < *ndim; ++i) { shp[i] = shape[i]; total *= shape[i]; }
  std::vector<float> f(data, data + total);  // R numerics are double
  *status = mxtpu_pred_set_input(h, name[0], f.data(), shp.data(), *ndim);
}

void mxtpu_r_forward(int *id, int *status) {
  void *h = get(*id);
  *status = h == nullptr ? -2 : mxtpu_pred_forward(h);
}

void mxtpu_r_num_outputs(int *id, int *n) {
  void *h = get(*id);
  *n = h == nullptr ? -2 : mxtpu_pred_num_outputs(h);
}

void mxtpu_r_output_shape(int *id, int *index, int *ndim, int *shape) {
  // shape must have room for 8 dims
  void *h = get(*id);
  if (h == nullptr) { *ndim = -2; return; }
  *ndim = mxtpu_pred_output_ndim(h, *index);
  if (*ndim <= 0 || *ndim > 8) return;
  int64_t shp[8];
  mxtpu_pred_output_shape(h, *index, shp);
  for (int i = 0; i < *ndim; ++i) shape[i] = static_cast<int>(shp[i]);
}

void mxtpu_r_get_output(int *id, int *index, double *out, int *size,
                        int *status) {
  void *h = get(*id);
  if (h == nullptr) { *status = -2; return; }
  std::vector<float> f(*size);
  int64_t n = mxtpu_pred_get_output(h, *index, f.data(), *size);
  if (n < 0) { *status = -1; return; }
  for (int64_t i = 0; i < n; ++i) out[i] = f[i];
  *status = 0;
}

void mxtpu_r_free(int *id) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_handles.find(*id);
  if (it != g_handles.end()) {
    mxtpu_pred_free(it->second);
    g_handles.erase(it);
  }
}

}  // extern "C"
