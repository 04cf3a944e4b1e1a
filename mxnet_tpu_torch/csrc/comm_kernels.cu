// Gradient-compression kernels for Hopper (sm_90a), behind a plain C
// interface: quantize (+ scales + the error-feedback round trip), the fused
// dequantize-and-sum of the reduce-scatter, and the dequantize of the
// all-gather, for the int8 and twobit codecs.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/comm_kernels.py:
//   quant_int8          _quant_int8_kernel    (pallas_call at :135)
//   quant_twobit        _quant_twobit_kernel  (:151)
//   dequant_sum_int8    _dqsum_int8_kernel    (:237)
//   dequant_sum_twobit  _dqsum_twobit_kernel  (:255)
//   dequant_int8        _dq_int8_kernel       (:291)
//   dequant_twobit      _dq_twobit_kernel     (:306)
//
// What they compute, bit for bit the JAX package's compiled arithmetic
// (and the plain versions in kernels/comm_kernels.py):
//   int8, per chunk of `chunk` elements of a row:
//     scale = max(max|x| * fl(1/127), 1e-30)    (NaN propagates)
//     q     = clip(rint(x / scale), -127, 127)  (true divide, half to even)
//     code  = int8(q), NaN -> 0                 (XLA's float-to-int cast)
//     dq    = q * scale                         (q before the cast)
//     err   = x - dq, the error feedback's stage-2 error, as the JAX
//             kernel path compiles it on the CPU: fma(-q, scale, x), one
//             rounding, where XLA contracts the product into the subtract
//             (a one-step grid), else x - (q * scale), two roundings
//   twobit: code = (x >= t) + 2 (x <= -t), four codes a byte,
//     c0 | c1 << 2 | c2 << 4 | c3 << 6; value(code) = t, -t, 0 for 1, 2, else
//   dequant_sum_int8:   acc = fma(q[r], scale[r], acc) for r = 0 .. R-1
//   dequant_sum_twobit: acc = acc + value(code[r])  for r = 0 .. R-1
// The rounding of each step is spelled out with intrinsics (__fmul_rn,
// __fdiv_rn, fmaf, __fadd_rn) so that nvcc neither contracts nor reorders
// it, and the max is written out because fmaxf drops a NaN.
//
// What bounds them. Each is one pass over its operands with a handful of
// f32 operations per element: memory bytes. At ResNet-50's padded gradient
// (25.56 M elements, two rows) the quantize reads 102 MB and writes 26 MB of
// codes, 0.4 MB of scales and 102 MB of round trip: 0.069 ms at 3.35 TB/s.
//
// Design. The TPU kernels stream (1, B) blocks of a row through VMEM on a
// sequential grid and carry the row sum in scratch from one grid step to the
// next. Here blocks run in parallel in no order, so the row sum is a loop
// inside one thread: a thread owns one column (int8) or one byte of columns
// (twobit) and walks the rows in order, which keeps the reference's order of
// the sum. The quantize gives one warp a chunk: the lanes read it
// coalesced, reduce |x| with shuffles, and read it again (from L1/L2) to
// emit codes and round trip. Any chunk that is a multiple of 4 works; the
// block size of the TPU kernels (`block_elems`) changes nothing here. Grids
// stride over the work. Loads are scalar, except in dequant_sum_int8.
//
// dequant_sum_int8 reads R rows of codes and writes one f32 row: at the
// two-rank exchange (R = 2, L = 12.78 M) 25.6 MB in and 51 MB out, 0.023 ms
// at 3.35 TB/s. A thread owns 16 consecutive columns: one 16-byte load a
// row, one scale load a 4-column quad (chunk % 4 == 0, so no quad straddles
// two chunks; the quad's scale index is stepped, not divided), four float4
// stores. Stored straight from each thread, those four land 64 bytes apart
// across a warp (half sectors), and the kernel read 54% of its bound
// (chip_smoke.py on an H100); so a warp stages its 512 results in shared
// memory and each store instruction writes 512 contiguous bytes.
// That path needs L % 16 == 0 and a 16-byte aligned q; elsewhere a thread
// owns 4 columns, read as one char4 (q 4-byte aligned) or as 4 bytes. The
// grid is the SMs times the blocks that fit on one, striding over the
// columns. The sum stays fmaf over rows 0..R-1 in order, so every path
// gives the bits of the scalar form.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kMinScale = 1e-30f;

// max that propagates NaN, like jnp.max / jnp.maximum (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ long long global_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long global_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// value of one twobit code: where(c == 1, t, 0) + where(c == 2, -t, 0)
__device__ __forceinline__ float twobit_value(unsigned code, float t) {
  return code == 1u ? t : (code == 2u ? -t : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
quant_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, float* __restrict__ dq,
                  float* __restrict__ err, int err_fma, long long n_chunks,
                  int chunk) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = global_stride() >> 5;
  for (long long c = global_index() >> 5; c < n_chunks; c += n_warps) {
    const long long base = c * chunk;
    float m = 0.0f;
    for (int i = lane; i < chunk; i += 32) m = nan_max(m, fabsf(x[base + i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = __fmul_rn(m, kInv127);
    s = (s > kMinScale || isnan(s)) ? s : kMinScale;
    if (lane == 0) scale[c] = s;
    for (int i = lane; i < chunk; i += 32) {
      const float xi = x[base + i];
      float v = rintf(__fdiv_rn(xi, s));
      v = v < -127.0f ? -127.0f : v;  // clip; a NaN passes both
      v = v > 127.0f ? 127.0f : v;
      q[base + i] = isnan(v) ? int8_t(0) : static_cast<int8_t>(static_cast<int>(v));
      if (dq != nullptr) dq[base + i] = __fmul_rn(v, s);
      if (err != nullptr)
        err[base + i] = err_fma ? fmaf(-v, s, xi) : __fsub_rn(xi, __fmul_rn(v, s));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
quant_twobit_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                    float* __restrict__ dq, long long n_bytes, float t) {
  for (long long b = global_index(); b < n_bytes; b += global_stride()) {
    unsigned packed = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = x[4 * b + k];
      const unsigned code = (v >= t ? 1u : 0u) + (v <= -t ? 2u : 0u);
      packed |= code << (2 * k);
      if (dq != nullptr) dq[4 * b + k] = twobit_value(code, t);
    }
    q[b] = static_cast<uint8_t>(packed);
  }
}

// kCols columns a thread: 16 (one int4 load a row) or 4 (one char4 load a
// row when kVector, else four byte loads). A warp's results go out through
// shared memory, so that each of its store instructions writes contiguous
// float4s. The loop runs whole warps (gb is the warp's first group), so
// that __syncwarp sees every lane.
template <int kCols, bool kVector>
__global__ void __launch_bounds__(kThreads)
dequant_sum_int8_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        float* __restrict__ out, int rows, long long length,
                        int chunk) {
  static_assert(kCols == 16 || kCols == 4, "16 or 4 columns a thread");
  constexpr int kQuads = kCols / 4;
  __shared__ float4 stage[kThreads / 32][32 * kQuads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long scales_per_row = length / chunk;
  const long long groups = length / kCols;
  for (long long gb = global_index() - lane; gb < groups;
       gb += global_stride()) {
    const long long g = gb + lane;
    const bool live = g < groups;
    const long long j0 = g * kCols;
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
    if (live) {
      // each quad's scale column: stepped from j0's, chunk a multiple of 4
      long long sidx[kQuads];
      {
        long long s = j0 / chunk;
        int off = static_cast<int>(j0 - s * chunk);
#pragma unroll
        for (int k = 0; k < kQuads; ++k) {
          sidx[k] = s;
          off += 4;
          if (off == chunk) {
            off = 0;
            ++s;
          }
        }
      }
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const int8_t* src = q + r * length + j0;
        alignas(16) int8_t b[kCols];
        if constexpr (kCols == 16) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(src));
          *reinterpret_cast<int4*>(b) = v;
        } else if constexpr (kVector) {
          const char4 v = __ldg(reinterpret_cast<const char4*>(src));
          b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = __ldg(src + c);
        }
        const float* srow = scale + r * scales_per_row;
#pragma unroll
        for (int k = 0; k < kQuads; ++k) {
          const float s = __ldg(srow + sidx[k]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * k + e] = fmaf(static_cast<float>(b[4 * k + e]), s,
                                  acc[4 * k + e]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kQuads; ++k)
      stage[warp][lane * kQuads + k] = make_float4(
          acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
    __syncwarp();
    // the warp's float4s in order: store s writes 32 of them side by side
    float4* dst = reinterpret_cast<float4*>(out) + gb * kQuads;
    const long long left = (groups - gb) * kQuads;
#pragma unroll
    for (int s = 0; s < kQuads; ++s)
      if (s * 32 + lane < left) dst[s * 32 + lane] = stage[warp][s * 32 + lane];
    __syncwarp();
  }
}

// blocks for `groups` threads: at most the SMs times the blocks of the
// kernel that fit on one SM at once
template <typename Kernel>
int resident_grid(Kernel kernel, long long groups) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long need = (groups + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(need < cap ? (need > 0 ? need : 1) : cap);
}

__global__ void __launch_bounds__(kThreads)
dequant_sum_twobit_kernel(const uint8_t* __restrict__ q,
                          float* __restrict__ out, int rows,
                          long long row_bytes, float t) {
  for (long long b = global_index(); b < row_bytes; b += global_stride()) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < rows; ++r) {
      const unsigned packed = q[r * row_bytes + b];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = __fadd_rn(acc[k], twobit_value((packed >> (2 * k)) & 3u, t));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * b + k] = acc[k];
  }
}

__global__ void __launch_bounds__(kThreads)
dequant_int8_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ out,
                    long long n, int chunk) {
  for (long long i = global_index(); i < n; i += global_stride())
    out[i] = __fmul_rn(static_cast<float>(q[i]), scale[i / chunk]);
}

__global__ void __launch_bounds__(kThreads)
dequant_twobit_kernel(const uint8_t* __restrict__ q, float* __restrict__ out,
                      long long n_bytes, float t) {
  for (long long b = global_index(); b < n_bytes; b += global_stride()) {
    const unsigned packed = q[b];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[4 * b + k] = twobit_value((packed >> (2 * k)) & 3u, t);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = launched). `grid` is
// the number of blocks of kThreads threads; the caller sizes it to the work
// and the card (dequant_sum_int8 sizes its own). Null dq skips the round
// trip, null err the error; err_fma picks its rounding.

int mxtt_quant_int8(const void* x, void* q, void* scale, void* dq, void* err,
                    int err_fma, long long n_chunks, int chunk, int grid,
                    void* stream) {
  quant_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), static_cast<float*>(dq),
      static_cast<float*>(err), err_fma, n_chunks, chunk);
  return static_cast<int>(cudaGetLastError());
}

int mxtt_quant_twobit(const void* x, void* q, void* dq, long long n_bytes,
                      float threshold, int grid, void* stream) {
  quant_twobit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(q),
      static_cast<float*>(dq), n_bytes, threshold);
  return static_cast<int>(cudaGetLastError());
}

// load_bytes: 16 (L % 16 == 0, q 16-byte aligned), 4 (q 4-byte aligned)
// or 1; the grid is sized here, to the card
int mxtt_dequant_sum_int8(const void* q, const void* scale, void* out,
                          int rows, long long length, int chunk,
                          int load_bytes, void* stream) {
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (load_bytes == 16) {
    auto kernel = dequant_sum_int8_kernel<16, true>;
    kernel<<<resident_grid(kernel, length / 16), kThreads, 0, st>>>(
        qp, sp, op, rows, length, chunk);
  } else if (load_bytes == 4) {
    auto kernel = dequant_sum_int8_kernel<4, true>;
    kernel<<<resident_grid(kernel, length / 4), kThreads, 0, st>>>(
        qp, sp, op, rows, length, chunk);
  } else {
    auto kernel = dequant_sum_int8_kernel<4, false>;
    kernel<<<resident_grid(kernel, length / 4), kThreads, 0, st>>>(
        qp, sp, op, rows, length, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

int mxtt_dequant_sum_twobit(const void* q, void* out, int rows,
                            long long row_bytes, float threshold, int grid,
                            void* stream) {
  dequant_sum_twobit_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<float*>(out), rows,
      row_bytes, threshold);
  return static_cast<int>(cudaGetLastError());
}

int mxtt_dequant_int8(const void* q, const void* scale, void* out,
                      long long n, int chunk, int grid, void* stream) {
  dequant_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), n, chunk);
  return static_cast<int>(cudaGetLastError());
}

int mxtt_dequant_twobit(const void* q, void* out, long long n_bytes,
                        float threshold, int grid, void* stream) {
  dequant_twobit_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<float*>(out), n_bytes,
      threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtt_comm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
