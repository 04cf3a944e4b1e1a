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
//     dq    = value(code)
//     err   = x - value(code), the error feedback's stage-1 error: one
//             rounding (__fsub_rn), as the JAX package's rows - dq1 (dq1
//             is a select, with no product for XLA to contract)
//   dequant_sum_int8:   acc = fma(q[r], scale[r], acc) for r = 0 .. R-1
//   dequant_sum_twobit: acc = acc + value(code[r])  for r = 0 .. R-1
// The rounding of each step is spelled out with intrinsics (__fmul_rn,
// __fdiv_rn, fmaf, __fadd_rn, __fsub_rn) so that nvcc neither contracts
// nor reorders it, and the max is written out because fmaxf drops a NaN.
//
// What bounds them. Each is one pass over its operands with a handful of
// f32 operations per element: memory bytes. At ResNet-50's padded gradient
// (25.56 M elements, two rows) the quantize reads 102 MB and writes 26 MB of
// codes, 0.4 MB of scales and 102 MB of round trip: 0.069 ms at 3.35 TB/s.
//
// Design. The TPU kernels stream (1, B) blocks of a row through VMEM on a
// sequential grid and carry the row sum in scratch from one grid step to the
// next. Here blocks run in parallel in no order, so the row sum is a loop
// inside one thread: a thread owns columns of a row and walks the rows in
// order, which keeps the reference's order of the sum. The block size of
// the TPU kernels (`block_elems`) changes nothing here. Grids stride over
// the work. Loads are scalar only in dequant_twobit and in quant_twobit's
// scalar form.
//
// quant_twobit reads R x L floats and writes R x L / 4 code bytes, and dq
// or err (or both) as R x L floats: at the 4 MB bucket with its error, 4 MB
// in, 4.25 MB out, 2.58 us at 3.35 TB/s. L % 4 == 0, so no code byte
// straddles two rows: the (R, L / 4) codes are the codes of the R * L
// elements taken flat, and the vector form needs only a 16-byte aligned x.
// A warp takes 512 consecutive elements: lane l loads float4s l, l + 32,
// l + 64 and l + 96 of them, all four before it uses one, so each load
// instruction reads 512 contiguous bytes; dq and err leave from the same
// positions, 512 contiguous bytes a store, with no staging. Float4 j of the
// 512 makes code byte j: each lane packs its four bytes into one word, and
// four shuffles give lane l the word of bytes 4l .. 4l + 3, which leaves as
// one 4-byte store (128 contiguous bytes a warp). The last 512 are masked
// by float4, so the tail (R * L mod 512 elements) runs in the same launch;
// its last code word, if partial, goes out byte by byte. Resident grid,
// 32-bit indices where the size allows. The first design, one code byte a
// thread from four scalar loads, stays as the scalar form: rows that are
// not 16-byte aligned take it, and so do inputs of fewer than 3 x 2^19
// elements in all, where the vector form measured no faster (the wrapper
// picks).
//
// dequant_sum_twobit reads R rows of B code bytes and writes 4B floats: at
// the bucket (R = 2, B = 131,072) 256 KB in and 2 MB out, 0.70 us. Row r
// starts at byte r * B, and B is odd at ResNet-50's two-rank gradient, so
// both forms read rows at any byte alignment.
// Its four-byte form gives a thread 4 consecutive code bytes of a row (16
// columns, in registers): the lanes of a warp load consecutive aligned
// words; where a row starts a bytes past a word, a lane's bytes are the
// last 4 - a of its own word and the first a of its neighbour's, which
// comes over with __shfl_down_sync (lane 31 loads the word past its own,
// before its first word is used) and is joined with __funnelshift_r. The
// results leave through shared memory, each store 512 contiguous bytes,
// the staged float4s swizzled so that the writes of a quarter warp hit
// eight bank groups. Its one-byte form gives a thread one code byte, read
// with one byte load (a warp's 32 loads fall in one 32-byte sector, the
// sector that four lanes sharing an aligned word would read; the word and
// its shift measured slower), and stores its four columns as one float4,
// so that a warp store writes 512 contiguous bytes with no staging.
// Sixteen bytes a thread was measured
// too and was the slowest at every bucket size; rows of B >= 3 x 2^16
// take the four-byte form, shorter rows the one-byte form, which ties or
// beats it there (the wrapper picks). In the four-byte form every aligned
// word that holds a code byte lies inside the codes except at their two
// ends, where a word reaches before the first code byte or past the last:
// such a word reads the bytes it holds of the tensor one by one, the
// form's only byte loads. Each form has its block fixed (128 threads for
// four bytes, 256 for one), the grid is the resident grid.
//
// quant_int8 gives one warp a chunk. Its first form (chunk a multiple of
// 128 up to 1024, rows 16-byte aligned; the chunk a template parameter)
// issues every load of the chunk before it uses one: lane l holds float4s
// l, l + 32, ... of the chunk in registers (chunk / 128 of them), so each
// load instruction reads 512 contiguous bytes and a whole 4 MB bucket
// (4,096 chunks of 256: 4,096 warps against 132 SMs x 64) is in flight in
// one wave. The max is taken by shuffles and the codes come from the
// registers, with no second read; the codes go out as one char4 a float4
// (128 contiguous bytes a warp store), dq and err as float4s. Its general
// form (any chunk that is a multiple of 4, any 4-byte aligned rows) walks
// the chunk with scalar loads, reduces, and reads it again (from L1/L2).
// A bucket is a view into one flat gradient buffer, so its base need not
// be 16-byte aligned: the wrapper picks the form from the chunk and the
// pointer. The grid of the first form is the resident grid (below).
//
// dequant_int8 writes R x L floats from R x L codes: at the 4 MB bucket
// (1 M codes) 1 MB in and 4 MB out, 1.57 us at 3.35 TB/s. It flattens the
// rows (L is a multiple of the chunk, so the scale of flat element i is
// scale[i / chunk]) and runs dequant_sum_int8's shape with one row: a
// thread owns 16 consecutive codes (one 16-byte load), finds their scale
// with one division a thread and steps it (one scale load where chunk % 16
// == 0), and its warp stages the products in shared memory so that each
// store instruction writes 512 contiguous bytes; indices are 32-bit where
// the size allows. Elsewhere (R * L % 16 != 0, or codes not 16-byte
// aligned) a thread owns 4 codes, read as one char4 or as 4 bytes.
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

// code of one element: inclusive at +-t, NaN -> 0
__device__ __forceinline__ unsigned twobit_code(float v, float t) {
  return (v >= t ? 1u : 0u) + (v <= -t ? 2u : 0u);
}

// An element's code, round trip and error from x and its chunk's scale s,
// as both forms of quant_int8 round them.
struct Int8Code {
  float v;  // the clipped quotient (NaN passes)
  __device__ __forceinline__ Int8Code(float xi, float s) {
    v = rintf(__fdiv_rn(xi, s));
    v = v < -127.0f ? -127.0f : v;
    v = v > 127.0f ? 127.0f : v;
  }
  __device__ __forceinline__ signed char code() const {
    return isnan(v) ? static_cast<signed char>(0)
                    : static_cast<signed char>(static_cast<int>(v));
  }
  __device__ __forceinline__ float dq(float s) const { return __fmul_rn(v, s); }
  __device__ __forceinline__ float err(float xi, float s, int err_fma) const {
    return err_fma ? fmaf(-v, s, xi) : __fsub_rn(xi, __fmul_rn(v, s));
  }
};

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
      const Int8Code k(xi, s);
      q[base + i] = k.code();
      if (dq != nullptr) dq[base + i] = k.dq(s);
      if (err != nullptr) err[base + i] = k.err(xi, s, err_fma);
    }
  }
}

// quant_int8's first form: kChunk / 128 float4s a lane, all loaded before
// the first is used (see the design notes above).
template <int kChunk>
__global__ void __launch_bounds__(kThreads)
quant_int8_chunk_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                        float* __restrict__ scale, float4* __restrict__ dq,
                        float4* __restrict__ err, int err_fma, int n_chunks) {
  static_assert(kChunk % 128 == 0 && kChunk <= 1024, "chunk 128 .. 1024");
  constexpr int kVecs = kChunk / 128;
  const int lane = threadIdx.x & 31;
  const int n_warps = (gridDim.x * kThreads) >> 5;
  for (int c = (blockIdx.x * kThreads + threadIdx.x) >> 5; c < n_chunks;
       c += n_warps) {
    const long long base = static_cast<long long>(c) * (kChunk / 4) + lane;
    float4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) v[j] = __ldg(x + base + 32 * j);
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      m = nan_max(m, fabsf(v[j].x));
      m = nan_max(m, fabsf(v[j].y));
      m = nan_max(m, fabsf(v[j].z));
      m = nan_max(m, fabsf(v[j].w));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = __fmul_rn(m, kInv127);
    s = (s > kMinScale || isnan(s)) ? s : kMinScale;
    if (lane == 0) scale[c] = s;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long at = base + 32 * j;
      const Int8Code a(v[j].x, s), b(v[j].y, s), cc(v[j].z, s), d(v[j].w, s);
      q[at] = make_char4(a.code(), b.code(), cc.code(), d.code());
      if (dq != nullptr)
        dq[at] = make_float4(a.dq(s), b.dq(s), cc.dq(s), d.dq(s));
      if (err != nullptr)
        err[at] = make_float4(a.err(v[j].x, s, err_fma),
                              b.err(v[j].y, s, err_fma),
                              cc.err(v[j].z, s, err_fma),
                              d.err(v[j].w, s, err_fma));
    }
  }
}

// quant_twobit's scalar form, its first design: one code byte a thread,
// from four scalar loads
__global__ void __launch_bounds__(kThreads)
quant_twobit_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                    float* __restrict__ dq, float* __restrict__ err,
                    long long n_bytes, float t) {
  for (long long b = global_index(); b < n_bytes; b += global_stride()) {
    unsigned packed = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = x[4 * b + k];
      const unsigned code = twobit_code(v, t);
      packed |= code << (2 * k);
      if (dq != nullptr) dq[4 * b + k] = twobit_value(code, t);
      if (err != nullptr) err[4 * b + k] = __fsub_rn(v, twobit_value(code, t));
    }
    q[b] = static_cast<uint8_t>(packed);
  }
}

// quant_twobit's vector form (see the design notes above): a warp takes
// 128 float4s, lane l the float4s l + 32 j; n4 float4s in all (= the code
// bytes). The loop runs whole warps, so that the shuffles see every lane.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
quant_twobit_vec_kernel(const float4* __restrict__ x, uint8_t* __restrict__ q,
                        float4* __restrict__ dq, float4* __restrict__ err,
                        Index n4, float t) {
  constexpr int kVecs = 4;  // a lane's float4s: one code word
  const int lane = threadIdx.x & 31;
  const Index slabs = (n4 + 32 * kVecs - 1) / (32 * kVecs);
  const Index n_warps = static_cast<Index>(gridDim.x) * (kThreads / 32);
  for (Index s = (static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       s < slabs; s += n_warps) {
    const Index base = s * (32 * kVecs);
    float4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const Index i = base + 32 * j + lane;
      v[j] = i < n4 ? __ldg(x + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    unsigned word = 0u;  // byte j: the codes of float4 j
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const unsigned c0 = twobit_code(v[j].x, t), c1 = twobit_code(v[j].y, t),
                     c2 = twobit_code(v[j].z, t), c3 = twobit_code(v[j].w, t);
      word |= (c0 | c1 << 2 | c2 << 4 | c3 << 6) << (8 * j);
      const Index i = base + 32 * j + lane;
      if (i < n4) {
        const float4 d = make_float4(twobit_value(c0, t), twobit_value(c1, t),
                                     twobit_value(c2, t), twobit_value(c3, t));
        if (dq != nullptr) dq[i] = d;
        if (err != nullptr)
          err[i] = make_float4(__fsub_rn(v[j].x, d.x), __fsub_rn(v[j].y, d.y),
                               __fsub_rn(v[j].z, d.z), __fsub_rn(v[j].w, d.w));
      }
    }
    // code byte b of the 128 is byte b / 32 of lane b % 32's word; lane l
    // stores bytes 4l .. 4l + 3, all in byte l / 8 of their lanes' words
    unsigned out = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned w = __shfl_sync(0xffffffffu, word, (4 * lane + k) & 31);
      out |= ((w >> (8 * (lane >> 3))) & 0xffu) << (8 * k);
    }
    const Index b0 = base + 4 * lane;
    if (b0 + 4 <= n4) {
      reinterpret_cast<unsigned*>(q)[b0 >> 2] = out;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (b0 + k < n4) q[b0 + k] = static_cast<uint8_t>(out >> (8 * k));
    }
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

// blocks of `threads` for `groups` threads: at most the SMs times the
// blocks of the kernel that fit on one SM at once
template <typename Kernel>
int resident_grid(Kernel kernel, long long groups, int threads = kThreads) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const long long need = (groups + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(need < cap ? (need > 0 ? need : 1) : cap);
}

// the aligned word at `at`: one 4-byte load where its bytes all lie in
// [beg, end), else the bytes that do, one by one, and zeros
__device__ __forceinline__ unsigned load_word(uintptr_t at, uintptr_t beg,
                                              uintptr_t end) {
  if (at >= beg && at + 4 <= end)
    return __ldg(reinterpret_cast<const unsigned*>(at));
  unsigned w = 0u;
  for (int i = 0; i < 4; ++i)
    if (at + i >= beg && at + i < end)
      w |= static_cast<unsigned>(
          __ldg(reinterpret_cast<const uint8_t*>(at + i))) << (8 * i);
  return w;
}

// dequant_sum_twobit's one-byte form (see the design notes above)
template <typename Index>
__global__ void __launch_bounds__(kThreads)
dequant_sum_twobit_byte_kernel(const uint8_t* __restrict__ q,
                               float* __restrict__ out, int rows,
                               Index row_bytes, float t) {
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index g = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
       g < row_bytes; g += stride) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < rows; ++r) {
      const unsigned byte = __ldg(q + static_cast<Index>(r) * row_bytes + g);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = __fadd_rn(acc[k], twobit_value((byte >> (2 * k)) & 3u, t));
    }
    reinterpret_cast<float4*>(out)[g] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// dequant_sum_twobit's four-byte form (see the design notes above): four
// code bytes of a row a thread, rows walked in order; each warp stages its
// 128 float4s in shared memory. The loop runs whole warps (gb is the warp's
// first group), so that the shuffles and __syncwarp see every lane.
constexpr int kFourThreads = 128;  // its block, measured (PERF.md)

template <typename Index>
__global__ void __launch_bounds__(kFourThreads)
dequant_sum_twobit_kernel(const uint8_t* __restrict__ q,
                          float* __restrict__ out, int rows, Index row_bytes,
                          float t) {
  __shared__ float4 stage_all[kFourThreads / 32][128];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* stage = stage_all[warp];
  // lane l's float4 i goes to slot 4 l + (i ^ ((l >> 1) & 3)): the eight
  // lanes of a quarter warp, writing the same i, hit eight bank groups
  auto slot = [](int l, int i) { return 4 * l + (i ^ ((l >> 1) & 3)); };
  const uintptr_t beg = reinterpret_cast<uintptr_t>(q);
  const uintptr_t end = beg + static_cast<uintptr_t>(rows) * row_bytes;
  const Index groups = (row_bytes + 3) / 4;
  const Index stride = static_cast<Index>(gridDim.x) * kFourThreads;
  for (Index gb = static_cast<Index>(blockIdx.x) * kFourThreads + warp * 32;
       gb < groups; gb += stride) {
    const Index g = gb + lane;
    float acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      const uintptr_t start = beg + static_cast<uintptr_t>(r) * row_bytes;
      const int a = static_cast<int>(start & 3);
      const uintptr_t own = start - a + static_cast<uintptr_t>(g) * 4;
      unsigned w = load_word(own, beg, end);
      // lane 31's word past its own, issued before the first is used
      unsigned next = 0u;
      if (a != 0 && lane == 31) next = load_word(own + 4, beg, end);
      if (a != 0) {  // the row starts off a 4-byte boundary
        const unsigned from = __shfl_down_sync(0xffffffffu, w, 1);
        if (lane != 31) next = from;
        w = __funnelshift_r(w, next, 8 * a);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned byte = (w >> (8 * i)) & 0xffu;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[4 * i + k] = __fadd_rn(acc[4 * i + k],
                                     twobit_value((byte >> (2 * k)) & 3u, t));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      stage[slot(lane, i)] = make_float4(acc[4 * i], acc[4 * i + 1],
                                         acc[4 * i + 2], acc[4 * i + 3]);
    __syncwarp();
    // the warp's float4s in order (one per code byte): store s writes 32
    // of them side by side
    float4* dst = reinterpret_cast<float4*>(out) + gb * 4;
    const Index left = row_bytes - gb * 4;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int f = s * 32 + lane;
      if (f < left) dst[f] = stage[slot(f >> 2, f & 3)];
    }
    __syncwarp();
  }
}

// out[i] = q[i] * scale[i / chunk] over n flat codes, kCols codes a
// thread: 16 (one int4 load) or 4 (one char4 load when kVector, else four
// byte loads); Index is int where n allows. As in dequant_sum_int8, the
// loop runs whole warps and each warp's products leave through shared
// memory, so that each store instruction writes contiguous float4s.
template <int kCols, bool kVector, typename Index>
__global__ void __launch_bounds__(kThreads)
dequant_int8_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ out,
                    Index n, int chunk) {
  static_assert(kCols == 16 || kCols == 4, "16 or 4 codes a thread");
  constexpr int kQuads = kCols / 4;
  __shared__ float4 stage[kThreads / 32][32 * kQuads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Index groups = n / kCols;
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index gb = static_cast<Index>(blockIdx.x) * kThreads + warp * 32;
       gb < groups; gb += stride) {
    const Index g = gb + lane;
    if (g < groups) {
      const Index j0 = g * kCols;
      const int8_t* src = q + j0;
      alignas(16) int8_t b[kCols];
      if constexpr (kCols == 16) {
        *reinterpret_cast<int4*>(b) = __ldg(reinterpret_cast<const int4*>(src));
      } else if constexpr (kVector) {
        const char4 v = __ldg(reinterpret_cast<const char4*>(src));
        b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = __ldg(src + c);
      }
      // the scale of each quad: one division, then stepped (chunk % 4 == 0,
      // so no quad straddles two chunks); loaded again only where it moves
      Index si = j0 / chunk;
      int off = static_cast<int>(j0 - si * chunk);
      float sc = __ldg(scale + si);
#pragma unroll
      for (int k = 0; k < kQuads; ++k) {
        if (k > 0 && off == 0) sc = __ldg(scale + si);
        stage[warp][lane * kQuads + k] = make_float4(
            __fmul_rn(static_cast<float>(b[4 * k]), sc),
            __fmul_rn(static_cast<float>(b[4 * k + 1]), sc),
            __fmul_rn(static_cast<float>(b[4 * k + 2]), sc),
            __fmul_rn(static_cast<float>(b[4 * k + 3]), sc));
        off += 4;
        if (off == chunk) {
          off = 0;
          ++si;
        }
      }
    }
    __syncwarp();
    // the warp's float4s in order: store s writes 32 of them side by side
    float4* dst = reinterpret_cast<float4*>(out) + gb * kQuads;
    const Index left = (groups - gb) * kQuads;
#pragma unroll
    for (int s = 0; s < kQuads; ++s)
      if (s * 32 + lane < left) dst[s * 32 + lane] = stage[warp][s * 32 + lane];
    __syncwarp();
  }
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

// quant_int8's first form: chunk a multiple of 128 up to 1024, x 16-byte
// aligned; the grid is sized here, to the card. Another chunk, or more
// than 2^31 - 1 chunks, is refused (cudaErrorInvalidValue).
int mxtt_quant_int8_chunked(const void* x, void* q, void* scale, void* dq,
                            void* err, int err_fma, long long n_chunks,
                            int chunk, void* stream) {
  if (n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<resident_grid(kernel, 32 * n_chunks), kThreads, 0, st>>>(
        static_cast<const float4*>(x), static_cast<char4*>(q),
        static_cast<float*>(scale), static_cast<float4*>(dq),
        static_cast<float4*>(err), err_fma, static_cast<int>(n_chunks));
    return static_cast<int>(cudaGetLastError());
  };
  switch (chunk) {
    case 128: return launch(quant_int8_chunk_kernel<128>);
    case 256: return launch(quant_int8_chunk_kernel<256>);
    case 384: return launch(quant_int8_chunk_kernel<384>);
    case 512: return launch(quant_int8_chunk_kernel<512>);
    case 640: return launch(quant_int8_chunk_kernel<640>);
    case 768: return launch(quant_int8_chunk_kernel<768>);
    case 896: return launch(quant_int8_chunk_kernel<896>);
    case 1024: return launch(quant_int8_chunk_kernel<1024>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// n_bytes code bytes (4 n_bytes floats); vector: the vector form, x
// 16-byte aligned, else the scalar one; null dq or err skips it. The grid
// is sized here, to the card.
int mxtt_quant_twobit(const void* x, void* q, void* dq, void* err,
                      long long n_bytes, float threshold, int vector,
                      void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (!vector) {
    auto kernel = quant_twobit_kernel;
    kernel<<<resident_grid(kernel, n_bytes), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<uint8_t*>(q),
        static_cast<float*>(dq), static_cast<float*>(err), n_bytes,
        threshold);
    return static_cast<int>(cudaGetLastError());
  }
  auto launch = [&](auto kernel, auto n4) {
    // a warp for each 128 float4s
    kernel<<<resident_grid(kernel, 32 * ((n_bytes + 127) / 128)), kThreads, 0,
             st>>>(static_cast<const float4*>(x), static_cast<uint8_t*>(q),
                   static_cast<float4*>(dq), static_cast<float4*>(err), n4,
                   threshold);
    return static_cast<int>(cudaGetLastError());
  };
  // 32-bit indices while every index the loop forms stays below 2^31
  if (n_bytes < (1LL << 30))
    return launch(quant_twobit_vec_kernel<int>, static_cast<int>(n_bytes));
  return launch(quant_twobit_vec_kernel<long long>, n_bytes);
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

// load_bytes: the code bytes of a row a thread, 1 (blocks of kThreads)
// or 4 (blocks of kFourThreads); another width is refused
// (cudaErrorInvalidValue). The grid is sized here.
int mxtt_dequant_sum_twobit(const void* q, void* out, int rows,
                            long long row_bytes, float threshold,
                            int load_bytes, void* stream) {
  if (load_bytes != 1 && load_bytes != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = load_bytes == 1 ? kThreads : kFourThreads;
  const auto* qp = static_cast<const uint8_t*>(q);
  auto* op = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long groups = (row_bytes + load_bytes - 1) / load_bytes;
  auto launch = [&](auto kernel, auto count) {
    kernel<<<resident_grid(kernel, groups, threads), threads, 0, st>>>(
        qp, op, rows, count, threshold);
    return static_cast<int>(cudaGetLastError());
  };
  // 32-bit indices while every index the loop forms stays below 2^31
  if (static_cast<long long>(rows) * row_bytes < (1LL << 30)) {
    const int m = static_cast<int>(row_bytes);
    if (load_bytes == 1) return launch(dequant_sum_twobit_byte_kernel<int>, m);
    return launch(dequant_sum_twobit_kernel<int>, m);
  }
  if (load_bytes == 1)
    return launch(dequant_sum_twobit_byte_kernel<long long>, row_bytes);
  return launch(dequant_sum_twobit_kernel<long long>, row_bytes);
}

// n flat codes; load_bytes: 16 (n % 16 == 0, q 16-byte aligned), 4 (q
// 4-byte aligned) or 1; the grid is sized here, to the card
int mxtt_dequant_int8(const void* q, const void* scale, void* out,
                      long long n, int chunk, int load_bytes, void* stream) {
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, auto count, int cols) {
    kernel<<<resident_grid(kernel, n / cols), kThreads, 0, st>>>(
        qp, sp, op, count, chunk);
    return static_cast<int>(cudaGetLastError());
  };
  // 32-bit indices while every index the loop forms stays below 2^31
  if (n < (1LL << 30)) {
    const int m = static_cast<int>(n);
    if (load_bytes == 16) return launch(dequant_int8_kernel<16, true, int>, m, 16);
    if (load_bytes == 4) return launch(dequant_int8_kernel<4, true, int>, m, 4);
    return launch(dequant_int8_kernel<4, false, int>, m, 4);
  }
  if (load_bytes == 16)
    return launch(dequant_int8_kernel<16, true, long long>, n, 16);
  if (load_bytes == 4)
    return launch(dequant_int8_kernel<4, true, long long>, n, 4);
  return launch(dequant_int8_kernel<4, false, long long>, n, 4);
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
