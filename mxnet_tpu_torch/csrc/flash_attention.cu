// Flash attention forward and backward for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the three TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py:
//   flash_fwd      (_fwd_kernel,     pallas_call at :120): online-softmax
//                  attention, o and the log-sum-exp lse of each query row;
//   flash_bwd_dq   (_bwd_dq_kernel,  pallas_call at :237): dq accumulated
//                  over key tiles from the saved lse;
//   flash_bwd_dkv  (_bwd_dkv_kernel, pallas_call at :256): dk and dv
//                  accumulated over query tiles.
// The plain versions are flash_fwd_plain and flash_bwd_plain in
// kernels/flash_attention.py. Every rounding point of the JAX kernels is
// kept: the scale multiplies the f32 product after the dot; masked scores are
// -1e30, not -inf; l_safe = max(l, 1e-30) and lse = m + log(l_safe); p is
// rounded to the value type before P.V, and ds = (p * (dp - delta)) * scale to
// the operand type before its products; o, dq, dk and dv are rounded from f32
// sums once, at the end. Multiplies that a sum follows use __fmul_rn, so nvcc
// contracts none of them into an FMA.
//
// What bounds it. At the transformer LM's shape (batch 8, 8 heads, seq 2048,
// head_dim 64, causal, bf16) the forward reads q, k, v and writes o and lse:
// 67.6 MB, 0.020 ms at 3.35 TB/s; the score entries of the causal triangle
// need 34.4 GFLOP, 0.035 ms at 989 TFLOP/s. That is some 500 operations per
// byte, above the card's 295 op/byte line: it is bound by operations, and
// the backward (3 and 4 products per score entry) more so. So the
// design keeps every product on the tensor cores and every score tile out of
// device memory.
//
// Design (FlashAttention-2's layout). A block of 4 warps owns one 64-row
// tile: query rows for flash_fwd and flash_bwd_dq, key rows for
// flash_bwd_dkv; each warp owns 16 of its rows. A loop over the other side's
// 64-row tiles takes the place of the TPU's sequential grid axis and its VMEM
// carry; the running max and sum (m, l) and the f32 accumulators stay in
// registers. Both backward kernels sum inside one block, with no atomics, so
// a result is the same from run to run. Causal tiles wholly above the
// diagonal are skipped, as _causal_run skips them. Tiles are staged in shared
// memory with 16-byte loads, through the caller's strides (q, k and v may be
// views of one packed qkv tensor; o may be written with the heads inside the
// sequence), zero-padded to DP = 32, 64 or 128 columns there and not in
// device memory; rows past the sequence are zero and masked (seq_k masking,
// flash_attention.py:56-63), so no padded copy exists.
//
// bf16: mma.sync m16n8k16 bf16 -> f32 for S = Q K^T, dP and every P.V-shaped
// product, with P and dS reused from the score fragments as the A operand and
// the B operand transposed by ldmatrix. f32 (the JAX tests' type and
// float32 configs): the same kernels with the products on the CUDA cores in
// full f32, no TF32, as the JAX side runs at precision "highest". fp16 is
// refused. wgmma, TMA, a pipelined ring of tiles and exp2 with a folded scale
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlock = 64;   // rows of a query tile and of a key tile
constexpr int kWarps = 4;    // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // flash_attention.py:34
constexpr int kScratchLd = kBlock + 4;  // f32 scratch row: 16 x 68 per warp

// One [B, H, S, D] operand with unit stride along D.
struct Operand {
  void* p;
  long long sb, sh, ss;
};

struct Args {
  Operand q, k, v, o, dout, dq, dk, dv;
  float* lse;          // [B * H, seq_q]
  const float* delta;  // [B * H, seq_q]
  int H, seq_q, seq_k, d, causal;
  float scale;
};

// shared-memory row stride of a DP-column tile: 16 bytes of padding, so the
// fragment loads of 8 consecutive rows hit distinct banks
template <typename T>
__host__ __device__ constexpr int ld_of(int dp) {
  return dp + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__device__ __forceinline__ T* row_ptr(const Operand& t, int bh, int H,
                                      int row) {
  const int b = bh / H, h = bh % H;
  return static_cast<T*>(t.p) + b * t.sb + h * t.sh +
         static_cast<long long>(row) * t.ss;
}

// Rows [row0, row0 + 64) of one (batch, head) slab into shared memory,
// columns [0, DP); zero past the sequence and past d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* __restrict__ smem,
                                          const Operand& t, int bh, int H,
                                          int row0, int rows, int d) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;
  constexpr int LD = ld_of<T>(DP);
  constexpr int kPer = kBlock * kChunks / kThreads;
  int4 val[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * kVec;
    val[i] = make_int4(0, 0, 0, 0);
    if (row0 + r < rows && col < d) {
      val[i] = *reinterpret_cast<const int4*>(row_ptr<T>(t, bh, H, row0 + r) +
                                              col);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<int4*>(smem + (c / kChunks) * LD +
                             (c % kChunks) * kVec) = val[i];
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Fragment layout of a warp's 16 x N f32 tile (mma's C): with g = lane / 4
// and t = lane % 4, element c[j][e] is row g + 8 * (e / 2), column
// 8 * j + 2 * t + e % 2.
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int j, int e) {
  return j * 8 + ((threadIdx.x & 31) & 3) * 2 + (e & 1);
}

// c = A B^T: A is the warp's 16 rows, B a 64-row tile, both [row][DP] in
// shared memory. c is 16 x 64 in fragments.
template <typename T, int DP>
__device__ __forceinline__ void qk_tile(float (&c)[8][4], const T* A,
                                        const T* B) {
  constexpr int LD = ld_of<T>(DP);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      const T* pa = A + g * LD + kk + 2 * t;
      a[0] = ld32(pa);
      a[1] = ld32(pa + 8 * LD);
      a[2] = ld32(pa + 8);
      a[3] = ld32(pa + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* pb = B + (j * 8 + g) * LD + kk + 2 * t;
        mma_bf16(c[j], a, ld32(pb), ld32(pb + 8));
      }
    }
  } else {
    for (int kk = 0; kk < DP; ++kk) {
      const float a0 = A[g * LD + kk], a1 = A[(g + 8) * LD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b0 = B[(j * 8 + 2 * t) * LD + kk];
        const float b1 = B[(j * 8 + 2 * t + 1) * LD + kk];
        c[j][0] = fmaf(a0, b0, c[j][0]);
        c[j][1] = fmaf(a0, b1, c[j][1]);
        c[j][2] = fmaf(a1, b0, c[j][2]);
        c[j][3] = fmaf(a1, b1, c[j][3]);
      }
    }
  }
}

// acc += round_T(p) B: p is the warp's 16 x 64 fragments, B a 64-row tile
// [row][DP] in shared memory, acc 16 x DP in fragments. ``scratch`` is the
// warp's 16 x 68 f32 area (f32 only: the row of p a product needs is spread
// over four threads).
template <typename T, int DP>
__device__ __forceinline__ void pv_tile(float (&acc)[DP / 8][4],
                                        const float (&p)[8][4], const T* B,
                                        float* scratch) {
  constexpr int LD = ld_of<T>(DP);
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // A fragment of keys [16 kc, 16 kc + 16) is the score fragments 2 kc
    // and 2 kc + 1; B (keys x dims) comes transposed out of ldmatrix:
    // matrices (keys 0-7 | 8-15) x (dims n0 | n0 + 8).
    const int mrow = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int mcol = (lane >> 4) * 8;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
      a[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
      a[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
      a[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
      for (int n0 = 0; n0 < DP; n0 += 16) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, B + (kc * 16 + mrow) * LD + n0 + mcol);
        mma_bf16(acc[n0 / 8], a, b[0], b[1]);
        mma_bf16(acc[n0 / 8 + 1], a, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        scratch[frag_row(e) * kScratchLd + frag_col(j, e)] = p[j][e];
    __syncwarp();
    const int g = lane >> 2, t = lane & 3;
    for (int key = 0; key < kBlock; ++key) {
      const float p0 = scratch[g * kScratchLd + key];
      const float p1 = scratch[(g + 8) * kScratchLd + key];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const float b0 = B[key * LD + j * 8 + 2 * t];
        const float b1 = B[key * LD + j * 8 + 2 * t + 1];
        acc[j][0] = fmaf(p0, b0, acc[j][0]);
        acc[j][1] = fmaf(p0, b1, acc[j][1]);
        acc[j][2] = fmaf(p1, b0, acc[j][2]);
        acc[j][3] = fmaf(p1, b1, acc[j][3]);
      }
    }
    __syncwarp();
  }
}

// Write the warp's 16 x DP f32 fragments, times ``mul`` per fragment row
// (1 / l_safe in the forward: a divide), as T into rows row0 + (warp's
// rows) of an operand; rows past ``rows`` and columns past d are dropped.
template <typename T, int DP, bool kDivide>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4],
                                           const float (&den)[2],
                                           const Operand& out, int bh, int H,
                                           int row0, int rows, int d) {
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    const int row = row0 + frag_row(hrow * 2);
    if (row >= rows) continue;
    T* dst = row_ptr<T>(out, bh, H, row);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = frag_col(j, 0);
      if (col >= d) continue;
      float x0 = acc[j][hrow * 2], x1 = acc[j][hrow * 2 + 1];
      if (kDivide) {
        x0 = __fdiv_rn(x0, den[hrow]);
        x1 = __fdiv_rn(x1, den[hrow]);
      }
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(dst + col) = make_float2(x0, x1);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int DP>
constexpr int tiles_bytes(int tiles) {
  return tiles * kBlock * ld_of<T>(DP) * static_cast<int>(sizeof(T)) +
         (std::is_same<T, float>::value
              ? kWarps * 16 * kScratchLd * static_cast<int>(sizeof(float))
              : 0);
}

// ---------------------------------------------------------------- forward

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld_of<T>(DP);
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kBlock * LD;
  T* sv = sk + kBlock * LD;
  const int warp = threadIdx.x >> 5;
  float* scratch = reinterpret_cast<float*>(sv + kBlock * LD) +
                   warp * 16 * kScratchLd;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const T* sq_w = sq + warp * 16 * LD;

  load_tile<T, DP>(sq, a.q, bh, a.H, q0, a.seq_q, a.d);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  int nk = (a.seq_k + kBlock - 1) / kBlock;
  if (a.causal) nk = min(nk, (q0 + kBlock - 1) / kBlock + 1);
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();  // every warp is done with the previous k, v tiles
    load_tile<T, DP>(sk, a.k, bh, a.H, kj * kBlock, a.seq_k, a.d);
    load_tile<T, DP>(sv, a.v, bh, a.H, kj * kBlock, a.seq_k, a.d);
    __syncthreads();
    float s[8][4];
    qk_tile<T, DP>(s, sq_w, sk);
    float mb[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + warp * 16 + frag_row(e);
        const int kpos = kj * kBlock + frag_col(j, e);
        const bool ok = kpos < a.seq_k && (!a.causal || qpos >= kpos);
        s[j][e] = ok ? __fmul_rn(s[j][e], a.scale) : kNegInf;
        mb[e >> 1] = fmaxf(mb[e >> 1], s[j][e]);
      }
    float mn[2], alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(m[r], quad_max(mb[r]));
      alpha[r] = expf(__fsub_rn(m[r], mn[r]));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + warp * 16 + frag_row(e);
        const int kpos = kj * kBlock + frag_col(j, e);
        const bool ok = kpos < a.seq_k && (!a.causal || qpos >= kpos);
        s[j][e] = ok ? expf(__fsub_rn(s[j][e], mn[e >> 1])) : 0.0f;
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), quad_sum(rs[r]));
      m[r] = mn[r];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = __fmul_rn(acc[j][e], alpha[e >> 1]);
    pv_tile<T, DP>(acc, s, sv, scratch);
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_safe[r] = fmaxf(l[r], 1e-30f);
  store_rows<T, DP, true>(acc, l_safe, a.o, bh, a.H, q0 + warp * 16, a.seq_q,
                          a.d);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + warp * 16 + frag_row(r * 2);
      if (qpos < a.seq_q) {
        a.lse[static_cast<long long>(bh) * a.seq_q + qpos] =
            __fadd_rn(m[r], logf(l_safe[r]));
      }
    }
  }
}

// ---------------------------------------------------------- backward: dq

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld_of<T>(DP);
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + kBlock * LD;
  T* sk = sdo + kBlock * LD;
  T* sv = sk + kBlock * LD;
  const int warp = threadIdx.x >> 5;
  float* scratch = reinterpret_cast<float*>(sv + kBlock * LD) +
                   warp * 16 * kScratchLd;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;

  load_tile<T, DP>(sq, a.q, bh, a.H, q0, a.seq_q, a.d);
  load_tile<T, DP>(sdo, a.dout, bh, a.H, q0, a.seq_q, a.d);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + warp * 16 + frag_row(r * 2);
    const long long i = static_cast<long long>(bh) * a.seq_q + qpos;
    lse[r] = qpos < a.seq_q ? a.lse[i] : 0.0f;
    delta[r] = qpos < a.seq_q ? a.delta[i] : 0.0f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  int nk = (a.seq_k + kBlock - 1) / kBlock;
  if (a.causal) nk = min(nk, (q0 + kBlock - 1) / kBlock + 1);
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();
    load_tile<T, DP>(sk, a.k, bh, a.H, kj * kBlock, a.seq_k, a.d);
    load_tile<T, DP>(sv, a.v, bh, a.H, kj * kBlock, a.seq_k, a.d);
    __syncthreads();
    float s[8][4], dp[8][4];
    qk_tile<T, DP>(s, sq + warp * 16 * LD, sk);
    qk_tile<T, DP>(dp, sdo + warp * 16 * LD, sv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qpos = q0 + warp * 16 + frag_row(e);
        const int kpos = kj * kBlock + frag_col(j, e);
        const bool ok = qpos < a.seq_q && kpos < a.seq_k &&
                        (!a.causal || qpos >= kpos);
        const float p =
            ok ? expf(__fsub_rn(__fmul_rn(s[j][e], a.scale), lse[r])) : 0.0f;
        // ds = (p * (dp - delta)) * scale, rounded to T inside pv_tile
        s[j][e] =
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[j][e], delta[r])), a.scale);
      }
    pv_tile<T, DP>(acc, s, sk, scratch);  // dq += ds k
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<T, DP, false>(acc, one, a.dq, bh, a.H, q0 + warp * 16, a.seq_q,
                           a.d);
}

// --------------------------------------------------------- backward: dkv

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld_of<T>(DP);
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + kBlock * LD;
  T* sq = sv + kBlock * LD;
  T* sdo = sq + kBlock * LD;
  const int warp = threadIdx.x >> 5;
  float* scratch = reinterpret_cast<float*>(sdo + kBlock * LD) +
                   warp * 16 * kScratchLd;
  __shared__ float slse[kBlock], sdelta[kBlock];
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;

  load_tile<T, DP>(sk, a.k, bh, a.H, k0, a.seq_k, a.d);
  load_tile<T, DP>(sv, a.v, bh, a.H, k0, a.seq_k, a.d);
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

  const int nq = (a.seq_q + kBlock - 1) / kBlock;
  // the first query tile whose last row reaches this key tile's first key
  const int q_first = a.causal ? k0 / kBlock : 0;
  for (int qi = q_first; qi < nq; ++qi) {
    const int q0 = qi * kBlock;
    __syncthreads();
    load_tile<T, DP>(sq, a.q, bh, a.H, q0, a.seq_q, a.d);
    load_tile<T, DP>(sdo, a.dout, bh, a.H, q0, a.seq_q, a.d);
    if (threadIdx.x < kBlock) {
      const int qpos = q0 + threadIdx.x;
      const long long i = static_cast<long long>(bh) * a.seq_q + qpos;
      slse[threadIdx.x] = qpos < a.seq_q ? a.lse[i] : 0.0f;
      sdelta[threadIdx.x] = qpos < a.seq_q ? a.delta[i] : 0.0f;
    }
    __syncthreads();
    // transposed scores: rows are this warp's keys, columns the queries
    float st[8][4], dpt[8][4];
    qk_tile<T, DP>(st, sk + warp * 16 * LD, sq);
    qk_tile<T, DP>(dpt, sv + warp * 16 * LD, sdo);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + warp * 16 + frag_row(e);
        const int ql = frag_col(j, e);
        const int qpos = q0 + ql;
        const bool ok = qpos < a.seq_q && kpos < a.seq_k &&
                        (!a.causal || qpos >= kpos);
        const float p =
            ok ? expf(__fsub_rn(__fmul_rn(st[j][e], a.scale), slse[ql]))
               : 0.0f;
        st[j][e] = p;
        dpt[j][e] =
            __fmul_rn(__fmul_rn(p, __fsub_rn(dpt[j][e], sdelta[ql])), a.scale);
      }
    pv_tile<T, DP>(dv, st, sdo, scratch);  // dv += p^T do
    pv_tile<T, DP>(dk, dpt, sq, scratch);  // dk += ds^T q
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<T, DP, false>(dk, one, a.dk, bh, a.H, k0 + warp * 16, a.seq_k,
                           a.d);
  store_rows<T, DP, false>(dv, one, a.dv, bh, a.H, k0 + warp * 16, a.seq_k,
                           a.d);
}

// ------------------------------------------------------------------ host

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int DP>
int launch(Which which, const Args& a, int bh, cudaStream_t stream) {
  void (*kernel)(Args);
  int bytes;
  int rows;
  if (which == kFwd) {
    kernel = flash_fwd_kernel<T, DP>;
    bytes = tiles_bytes<T, DP>(3);
    rows = a.seq_q;
  } else if (which == kDq) {
    kernel = flash_bwd_dq_kernel<T, DP>;
    bytes = tiles_bytes<T, DP>(4);
    rows = a.seq_q;
  } else {
    kernel = flash_bwd_dkv_kernel<T, DP>;
    bytes = tiles_bytes<T, DP>(4);
    rows = a.seq_k;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dp(Which which, const Args& a, int bh, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32>(which, a, bh, stream);
  if (a.d <= 64) return launch<T, 64>(which, a, bh, stream);
  return launch<T, 128>(which, a, bh, stream);
}

Operand operand(const void* p, const long long* strides) {
  Operand t;
  t.p = const_cast<void*>(p);
  t.sb = strides[0];
  t.sh = strides[1];
  t.ss = strides[2];
  return t;
}

int run(Which which, const Args& a, int B, int dtype, void* stream) {
  // the wrapper checks these; a bad call must not reach the kernels
  if (a.d < 8 || a.d > 128 || a.d % 8 != 0 || B < 1 || a.H < 1 ||
      a.seq_q < 1 || a.seq_k < 1 || B * a.H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dp<__nv_bfloat16>(which, a, B * a.H, s);
  if (dtype == 1) return launch_dp<float>(which, a, B * a.H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args base_args(int H, int seq_q, int seq_k, int d, int causal, float scale) {
  Args a = {};
  a.H = H;
  a.seq_q = seq_q;
  a.seq_k = seq_k;
  a.d = d;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// Operands are [B, H, seq, d] with unit stride along d; ``strides`` holds
// (batch, head, seq) element strides per operand, in argument order. lse and
// delta are contiguous [B * H, seq_q] f32. dtype: 0 bf16, 1 f32. Each call
// returns the CUDA error of its launch (0 on success).

int mxtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* strides, int B, int H,
                   int seq_q, int seq_k, int d, int causal, float scale,
                   int dtype, void* stream) {
  Args a = base_args(H, seq_q, seq_k, d, causal, scale);
  a.q = operand(q, strides);
  a.k = operand(k, strides + 3);
  a.v = operand(v, strides + 6);
  a.o = operand(o, strides + 9);
  a.lse = lse;
  return run(kFwd, a, B, dtype, stream);
}

int mxtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, const long long* strides, int B, int H,
                      int seq_q, int seq_k, int d, int causal, float scale,
                      int dtype, void* stream) {
  Args a = base_args(H, seq_q, seq_k, d, causal, scale);
  a.q = operand(q, strides);
  a.k = operand(k, strides + 3);
  a.v = operand(v, strides + 6);
  a.dout = operand(dout, strides + 9);
  a.dq = operand(dq, strides + 12);
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  return run(kDq, a, B, dtype, stream);
}

int mxtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* strides, int B,
                       int H, int seq_q, int seq_k, int d, int causal,
                       float scale, int dtype, void* stream) {
  Args a = base_args(H, seq_q, seq_k, d, causal, scale);
  a.q = operand(q, strides);
  a.k = operand(k, strides + 3);
  a.v = operand(v, strides + 6);
  a.dout = operand(dout, strides + 9);
  a.dk = operand(dk, strides + 12);
  a.dv = operand(dv, strides + 15);
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  return run(kDkv, a, B, dtype, stream);
}

const char* mxtt_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
