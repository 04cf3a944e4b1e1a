// Int8 matmul with a scale per activation row and per weight channel, for
// Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/matmul.py:_int8_mm_kernel
// (pallas_call name "int8_matmul"). For x (M,K) f32, wq (N,K) int8 and
// sw (N,) f32 it computes
//   sx[m]  = max(max_k |x[m,k]| * (1/127), 1e-30)    1/127 rounded to f32
//   qx     = clip(rint(x / sx), -127, 127)               int8, half to even
//   y[m,n] = (float(sum_k qx[m,k] * wq[n,k]) * sx[m]) * sw[n]
// The plain version is int8_matmul_plain in kernels/int8_matmul.py. The scale
// multiplies by the f32 reciprocal of 127, as the JAX package's compiled
// kernel does (XLA rewrites its divide by the constant 127 into that).
//
// What bounds it. At the ResNet-50 fc1 shape with batch 32 (M=32, K=2048,
// N=1000) a call must move about 2.4 MB (x f32 0.26 MB, wq 2.0 MB, y 0.13 MB)
// and do 131 M int8 operations: about 0.73 us at 3.35 TB/s against 0.07 us
// at 1979 TOP/s. It is bound by memory, by the weight bytes above all; but
// 0.73 us is below what two dependent launches and a few trips to device
// memory take, so at small M the design is about latency: fill the card,
// put every weight load in flight at once, and keep the steps after the
// loads few.
//
// Design: two launches on the caller's stream.
//  1. Row pre-pass. One block per row reduces max|x|, then writes sx and the
//     int8 row qx (the TPU kernel fused this into every output tile, because
//     its VMEM tiles hold whole rows). It is launched as a primary of
//     programmatic dependent launch and lets the GEMM start at once
//     (griddepcontrol.launch_dependents).
//  2. Split-K GEMM. A block owns a 64x64 tile of y and one K-slice of it:
//     ``per`` slabs of 256 bytes. Each warp computes 32x32 with mma.sync
//     m16n8k32 s8*s8->s32 from shared memory, whose rows are padded to 272
//     bytes so that the fragment loads are free of bank conflicts. A slab
//     of wq and of qx comes in with 16-byte loads into registers, all of a
//     thread's in flight at once, the next slab's during the current one's
//     products; the weight loads are issued before griddepcontrol.wait, so
//     the 2 MB weight stream does not wait for the pre-pass, and the qx
//     loads after it. (Bulk copies, one cp.async.bulk a row into a
//     two-stage mbarrier ring, measured slower on the H100 at every shape
//     tried, split or not.)
//     The wrapper picks the split (kernels/int8_matmul.py:_k_split): at
//     small M, K is split until about 128 blocks run (fc1: 16 N-tiles x 8
//     K-slices of one slab each); where the tiles fill the card already
//     (M=256, K=N=4096: 256 tiles of 16 slabs), none. The K-slices of one
//     output tile are one thread-block cluster (at most 8, along
//     gridDim.z). Each block leaves its int32 partial tile in its shared
//     memory; after a cluster barrier, block r sums every rank's partial
//     of its share of the tile through distributed shared memory, in rank
//     order, and applies the scales. Integer sums are exact, so the result
//     is bitwise the plain version's whatever the split, with no
//     workspace, memset or atomics.
//     The sum is exact in int32: |acc| <= 127*127*K < 2^31 for
//     K <= 133144, which the wrapper checks. The TPU kernel accumulates in
//     f32, which is exact only while partial sums stay below 2^24 (K up to
//     about 1040).
//  A K that is not a multiple of 16, or an unaligned operand, takes byte
//  loads (the same split and reduction).
//
// Numerics: the divide and multiplies use the explicitly IEEE-rounded
// intrinsics, so the result is bitwise the plain version's whatever the
// compiler flags.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowThreads = 256;
constexpr int kTile = 64;          // BM = BN = 64 rows of qx / wq per block
constexpr int kDepth = 256;        // bytes of K a slab
constexpr int kLds = kDepth + 16;  // padded row stride: 68 words, so rows
                                   // g = 0..7 start 4 banks apart
constexpr int kGemmThreads = 128;  // 4 warps, each 32x32 of the 64x64 tile
constexpr int kSlab = kTile * kLds;  // one operand's slab in shared memory
constexpr int kMaxSplit = 8;         // a portable cluster
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__global__ void __launch_bounds__(kRowThreads)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ qx,
                     float* __restrict__ sx, int K) {
  // the GEMM may start now: it waits for this grid before it reads qx, sx
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float partial[kRowThreads / 32];
  __shared__ float scale;
  const int m = blockIdx.x;
  const float* row = x + static_cast<size_t>(m) * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float amax = 0.0f;
  for (int k = threadIdx.x; k < K; k += kRowThreads) {
    amax = fmaxf(amax, fabsf(row[k]));
  }
  amax = warp_max(amax);
  if (lane == 0) partial[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = warp_max(lane < kRowThreads / 32 ? partial[lane] : 0.0f);
    if (lane == 0) {
      scale = fmaxf(__fmul_rn(amax, kInv127), 1e-30f);
      sx[m] = scale;
    }
  }
  __syncthreads();

  const float s = scale;
  int8_t* qrow = qx + static_cast<size_t>(m) * K;
  for (int k = threadIdx.x; k < K; k += kRowThreads) {
    const float q = rintf(__fdiv_rn(row[k], s));
    qrow[k] = static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
  }
}

// Rows [r0, r0+64) x bytes [k0, k0+kDepth) of a row-major (rows, K) int8
// matrix into registers, 16 bytes a chunk, zero past either edge; all of a
// thread's loads are issued before any is used. kVec: 16-byte loads (K a
// multiple of 16, 16-byte-aligned base); else byte loads (any K).
constexpr int kChunks = kTile * kDepth / 16 / kGemmThreads;  // 8 a thread

template <bool kVec>
__device__ __forceinline__ void load_slab(int4 (&v)[kChunks], const int8_t* g,
                                          int rows, int K, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kGemmThreads;
    const int gr = r0 + c / (kDepth / 16);
    const int gk = k0 + (c % (kDepth / 16)) * 16;
    v[i] = make_int4(0, 0, 0, 0);
    if (gr < rows) {
      const int8_t* src = g + static_cast<size_t>(gr) * K + gk;
      if (kVec) {
        if (gk < K) v[i] = *reinterpret_cast<const int4*>(src);
      } else {
        int8_t* bytes = reinterpret_cast<int8_t*>(&v[i]);
        for (int b = 0; b < 16; ++b) {
          if (gk + b < K) bytes[b] = src[b];
        }
      }
    }
  }
}

__device__ __forceinline__ void store_slab(unsigned char* smem,
                                           const int4 (&v)[kChunks]) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kGemmThreads;
    *reinterpret_cast<int4*>(smem + (c / (kDepth / 16)) * kLds +
                             (c % (kDepth / 16)) * 16) = v[i];
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += the warp's 32x32 of (qx slab) (wq slab)^T
__device__ __forceinline__ void slab_mma(int (&acc)[2][4][4],
                                         const unsigned char* a_tile,
                                         const unsigned char* b_tile, int wm,
                                         int wn) {
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;  // mma fragment: groupID
  const int tig = lane & 3;   // mma fragment: threadID_in_group
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 32) {
    // A (row-major 16x32): a0 row g, a1 row g+8, a2/a3 the same rows 16
    // bytes further; each register holds 4 consecutive K bytes.
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const unsigned char* p = a_tile + (wm + i * 16 + grp) * kLds + kk +
                               tig * 4;
      a[i][0] = ld32(p);
      a[i][1] = ld32(p + 8 * kLds);
      a[i][2] = ld32(p + 16);
      a[i][3] = ld32(p + 8 * kLds + 16);
    }
    // B (col-major 32x8) is a row of wq: b0 = K bytes 4t..4t+3 of row g,
    // b1 the same 16 bytes further.
    uint32_t b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned char* p = b_tile + (wn + j * 8 + grp) * kLds + kk +
                               tig * 4;
      b[j][0] = ld32(p);
      b[j][1] = ld32(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
  }
}

__device__ __forceinline__ float scaled(int acc, float s, float w) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s), w);
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Grid (N tiles, M tiles, K-slices); the K-slices of a tile are one
// cluster. Block z sums slabs [z * per, min((z + 1) * per, slabs)).
// qx and sx are the pre-pass's, which may still be running when this grid
// starts: they are not const __restrict__, or the compiler may read them
// through the non-coherent cache ahead of griddepcontrol.wait (on the H100
// that read stale scratch in most calls).
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads)
int8_gemm_kernel(const int8_t* qx, const int8_t* __restrict__ wq,
                 const float* sx, const float* __restrict__ sw,
                 float* __restrict__ y, int M, int N, int K, int per) {
  __shared__ __align__(16) unsigned char smem[2 * kSlab];  // qx, then wq
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32;  // the warp's rows within the tile
  const int wn = (warp & 1) * 32;   // the warp's columns within the tile
  const int slabs = (K + kDepth - 1) / kDepth;
  const int s_first = blockIdx.z * per;
  const int count = min(per, slabs - s_first);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  int4 va[kChunks], vb[kChunks];
  // the weights do not depend on the pre-pass: in flight before its end
  load_slab<kVec>(vb, wq, N, K, n0, s_first * kDepth);
  grid_dependency_wait();
  load_slab<kVec>(va, qx, M, K, m0, s_first * kDepth);
  for (int i = 0; i < count; ++i) {
    store_slab(smem, va);
    store_slab(smem + kSlab, vb);
    __syncthreads();
    if (i + 1 < count) {  // in flight during this slab's products
      const int k0 = (s_first + i + 1) * kDepth;
      load_slab<kVec>(vb, wq, N, K, n0, k0);
      load_slab<kVec>(va, qx, M, K, m0, k0);
    }
    slab_mma(acc, smem, smem + kSlab, wm, wn);
    __syncthreads();
  }

  // C fragment: c0, c1 at row g, columns 2t and 2t+1; c2, c3 at row g+8.
  const int grp = lane >> 2, tig = lane & 3;
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + grp + h * 8;
        if (m >= M) continue;
        const float s = sx[m];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn + j * 8 + tig * 2 + e;
            if (n < N) {
              y[static_cast<size_t>(m) * N + n] =
                  scaled(acc[i][j][h * 2 + e], s, sw[n]);
            }
          }
        }
      }
    }
    return;
  }

  // split K: the partial tile into this block's shared memory (free: the
  // loop ended on a barrier), then each rank reduces its share of the tile
  // over the cluster, in rank order
  int* part = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          part[(wm + i * 16 + grp + h * 8) * kTile + wn + j * 8 + tig * 2 +
               e] = acc[i][j][h * 2 + e];
        }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int c = rank * kGemmThreads + threadIdx.x; c < kTile * kTile;
       c += ranks * kGemmThreads) {
    const int m = m0 + c / kTile, n = n0 + c % kTile;
    if (m >= M || n >= N) continue;
    int sum = 0;
    for (int r = 0; r < ranks; ++r) sum += cluster.map_shared_rank(part, r)[c];
    y[static_cast<size_t>(m) * N + n] = scaled(sum, sx[m], sw[n]);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <bool kVec>
cudaError_t launch_gemm(const int8_t* qx, const int8_t* wq, const float* sx,
                        const float* sw, float* y, int M, int N, int K,
                        int per, cudaStream_t s) {
  const int split = ((K + kDepth - 1) / kDepth + per - 1) / per;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, split);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.stream = s;
  cfg.attrs = attrs;
  cfg.numAttrs = split > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, int8_gemm_kernel<kVec>, qx, wq, sx, sw, y,
                            M, N, K, per);
}

}  // namespace

extern "C" {

// y = int8_matmul(x, wq, sw); qx (M,K) int8 and sx (M,) f32 are scratch the
// caller allocates. ``per``: 256-byte K slabs a block sums; the blocks of
// one output tile, ceil(ceil(K / 256) / per) of them, must be at most 8.
// Returns the CUDA error of the launches (0 on success).
int mxtt_int8_matmul(const float* x, const int8_t* wq, const float* sw,
                     int8_t* qx, float* sx, float* y, int M, int N, int K,
                     int per, void* stream) {
  const int slabs = (K + kDepth - 1) / kDepth;
  if (M < 1 || N < 1 || K < 1 || per < 1 ||
      (slabs + per - 1) / per > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<<<M, kRowThreads, 0, s>>>(x, qx, sx, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = K % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(qx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  err = vec ? launch_gemm<true>(qx, wq, sx, sw, y, M, N, K, per, s)
            : launch_gemm<false>(qx, wq, sx, sw, y, M, N, K, per, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
