// Multi-tensor Adam/AdamW step for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/adam.py:_adam_kernel
// (pallas_call name "fused_adam"). For every parameter leaf l, with its
// gradient g, moments m and v, and per-leaf f32 scalars c1 = 1 - beta1^t,
// c2 = 1 - beta2^t and wd (AdamW's decay after the decay filter), it
// updates w, m and v in place:
//   g  = g * rescale;  g = clip(g, -clip, clip) (NaN passes);  g = g + wd_l2*w
//   m  = beta1*m + (1-beta1)*g
//   v  = beta2*v + (1-beta2)*(g*g)
//   w' = w - (lr * (m/c1)) / (sqrt(v/c2) + eps)
//   w' = w' - (lr*wd) * w                                   (AdamW only)
// in exactly that order, each operation rounded on its own: the intrinsics
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn keep nvcc from
// contracting a*b+c into one FMA, so the result is bitwise the plain
// version's (fused_adam_plain in kernels/fused_adam.py, one torch kernel per
// operation) and the per-leaf Optimizer.apply's.
//
// What bounds it. The step reads w, g, m, v and writes w, m, v: 28 bytes and
// about 14 f32 operations per element. For ResNet-50's 25.56 M parameters
// that is 716 MB, 0.214 ms at 3.35 TB/s, against 0.005 ms of f32 work at
// 67 TFLOP/s: it is bound by memory bytes.
//
// Design. The TPU kernel concatenates the leaves into one slab padded to
// whole tiles, because its grid walks one dense array; the padding,
// concatenation and slicing around it are copies of their own. Here one
// launch walks the leaves where they lie. The caller keeps three device
// tables for as long as the tensors stay where they are: per leaf the
// pointers of w, m and v and the element count; per leaf the pointer of g;
// and the work items (leaf, chunk), each chunk kChunk elements of one leaf.
// What changes from step to step is read from device memory, not passed by
// value: a float vector of lr, then per leaf c1, c2 and wd. So a launch
// captured into a CUDA graph reads each replay's values, which the caller
// copies into that vector before the replay. The grid strides over the
// items. Chunks of a leaf whose four pointers are 16-byte aligned move 16
// bytes per thread per array (float4) with a scalar tail; other leaves, and
// a 0-d leaf, go element by element.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// elements of one leaf per work item; kernels/fused_adam.py's CHUNK
constexpr int kChunk = kThreads * 4 * 16;
constexpr int kLeafWords = 4;  // w, m, v, numel
// the per-step vector: lr, then (c1, c2, wd) per leaf;
// kernels/fused_adam.py's HEADER and PER_LEAF
constexpr int kHeader = 1;
constexpr int kPerLeaf = 3;

struct AdamParams {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
  float rescale, clip, wd_l2;
  int has_clip, decoupled;
};

__device__ __forceinline__ void adam_elem(float& w, float g, float& m,
                                          float& v, const AdamParams& p,
                                          float lr, float c1, float c2,
                                          float lr_wd) {
  g = __fmul_rn(g, p.rescale);
  if (p.has_clip && !isnan(g)) g = fminf(fmaxf(g, -p.clip), p.clip);
  g = __fadd_rn(g, __fmul_rn(p.wd_l2, w));
  m = __fadd_rn(__fmul_rn(p.beta1, m), __fmul_rn(p.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(p.beta2, v),
                __fmul_rn(p.one_minus_beta2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m, c1);
  const float vhat = __fdiv_rn(v, c2);
  float nw = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, mhat),
                                    __fadd_rn(__fsqrt_rn(vhat), p.eps)));
  if (p.decoupled) nw = __fsub_rn(nw, __fmul_rn(lr_wd, w));
  w = nw;
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const int64_t* __restrict__ leaves,
                  const int64_t* __restrict__ grads,
                  const float* __restrict__ scal,
                  const int2* __restrict__ items, int n_items, AdamParams p) {
  const float lr = scal[0];
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int2 item = items[it];
    const int64_t* leaf = leaves + static_cast<int64_t>(item.x) * kLeafWords;
    const float* step = scal + kHeader + item.x * kPerLeaf;
    float* w = reinterpret_cast<float*>(leaf[0]);
    float* m = reinterpret_cast<float*>(leaf[1]);
    float* v = reinterpret_cast<float*>(leaf[2]);
    const float* g = reinterpret_cast<const float*>(grads[item.x]);
    const int64_t numel = leaf[3];
    const bool aligned =
        ((leaf[0] | leaf[1] | leaf[2] | grads[item.x]) & 15) == 0;
    const float c1 = step[0], c2 = step[1];
    const float lr_wd = __fmul_rn(lr, step[2]);
    const int64_t start = static_cast<int64_t>(item.y) * kChunk;
    const int64_t end = numel < start + kChunk ? numel : start + kChunk;
    int64_t tail = start;
    if (aligned) {
      const int64_t n4 = (end - start) / 4;
      float4* w4 = reinterpret_cast<float4*>(w + start);
      const float4* g4 = reinterpret_cast<const float4*>(g + start);
      float4* m4 = reinterpret_cast<float4*>(m + start);
      float4* v4 = reinterpret_cast<float4*>(v + start);
      for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
        float4 wv = w4[i];
        const float4 gv = __ldg(g4 + i);
        float4 mv = m4[i];
        float4 vv = v4[i];
        adam_elem(wv.x, gv.x, mv.x, vv.x, p, lr, c1, c2, lr_wd);
        adam_elem(wv.y, gv.y, mv.y, vv.y, p, lr, c1, c2, lr_wd);
        adam_elem(wv.z, gv.z, mv.z, vv.z, p, lr, c1, c2, lr_wd);
        adam_elem(wv.w, gv.w, mv.w, vv.w, p, lr, c1, c2, lr_wd);
        w4[i] = wv;
        m4[i] = mv;
        v4[i] = vv;
      }
      tail = start + n4 * 4;
    }
    for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
      float wv = w[i], mv = m[i], vv = v[i];
      adam_elem(wv, g[i], mv, vv, p, lr, c1, c2, lr_wd);
      w[i] = wv;
      m[i] = mv;
      v[i] = vv;
    }
  }
}

}  // namespace

extern "C" {

// One Adam/AdamW step over every leaf of the tables, in place. ``leaves``
// (L x 4 int64), ``grads`` (L int64), ``scal`` (1 + 3L f32: lr, then c1,
// c2, wd per leaf) and ``items`` (n_items x 2 int32) are device memory;
// ``grid`` is the number of blocks to launch. Returns the CUDA error of the
// launch (0 on success).
int mxtt_fused_adam(const int64_t* leaves, const int64_t* grads,
                    const float* scal,
                    const int* items, int n_items, int grid, float beta1,
                    float one_minus_beta1, float beta2,
                    float one_minus_beta2, float eps, float rescale,
                    float clip, int has_clip, float wd_l2, int decoupled,
                    void* stream) {
  if (n_items <= 0) return 0;
  AdamParams p;
  p.beta1 = beta1;
  p.one_minus_beta1 = one_minus_beta1;
  p.beta2 = beta2;
  p.one_minus_beta2 = one_minus_beta2;
  p.eps = eps;
  p.rescale = rescale;
  p.clip = clip;
  p.wd_l2 = wd_l2;
  p.has_clip = has_clip;
  p.decoupled = decoupled;
  fused_adam_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, grads, scal, reinterpret_cast<const int2*>(items), n_items,
      p);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtt_fused_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
