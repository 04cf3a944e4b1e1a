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
// kernels/flash_attention.py. The rounding points of the JAX kernels are
// kept: masked scores are -1e30, not -inf; l_safe = max(l, 1e-30) and
// lse = m + log(l_safe); p is rounded to the value type before P.V, and
// ds = (p * (dp - delta)) * scale to the operand type before its products;
// o, dq, dk and dv are rounded from f32 sums once, at the end. Two designs
// live here, chosen by the operands' type.
//
// What bounds it. At the transformer LM's shape (batch 8, 8 heads, seq 2048,
// head_dim 64, causal, bf16) the forward reads q, k, v and writes o and lse:
// 67.6 MB, 0.020 ms at 3.35 TB/s; the score entries of the causal triangle
// need 34.4 GFLOP, 0.035 ms at 989 TFLOP/s; dk/dv needs 68.8 GFLOP, 0.070
// ms. That is some 500 operations per byte, above the card's 295 op/byte
// line: bound by operations, so every product belongs on the tensor cores
// at their Hopper rate, and every score tile out of device memory.
//
// bf16 forward and dk/dv: warp-specialised Hopper kernels (the second
// half of this file). A block is 384 threads: two consumer warpgroups and
// a producer warpgroup of which one warp works.
//   - The producer warp issues TMA loads (cp.async.bulk.tensor) into a
//     ring of stages in shared memory and signals them on mbarriers; the
//     consumers release a stage once the wgmmas reading it have retired.
//     The tensor maps are rank 4 over (d, seq, head, batch) with the
//     operands' own strides, so q, k, v stay views of the packed qkv. TMA's
//     zero fill pads d to 64 or 128 and the sequence's ragged tail; a
//     128-column row is two 64-column boxes, each one 128-byte swizzle span.
//   - Every product is a wgmma from 128B-swizzled shared memory. Forward:
//     S = Q K^T (both operands in shared memory), then O += P V with P
//     rounded to bf16 in registers as the A operand and V read MN-major.
//     dk/dv: S^T = K Q^T and dP^T = V dO^T from shared memory, then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T from the accumulator
//     fragments; K and V stay resident, Q, dO, lse and delta stream.
//   - Tiles: the forward's block owns 128 query rows (64 per consumer
//     warpgroup) and streams 64-key K/V tiles, so each is loaded once per
//     128 rows; dk/dv's block owns 128 keys and streams 64-query tiles. The
//     key tile stays the 64 of the plain version, whose bf16 results depend
//     on it through the online rescale.
//   - Softmax: masks only on the tile that crosses the causal diagonal and
//     the one past the sequence's end; exponentials are ex2.approx of one
//     FMA, s * (scale * log2 e) - m * (scale * log2 e); lse goes back to
//     natural-log units once, at the end. Causal blocks are launched with
//     the longest query tiles (forward) or key tiles (dk/dv) first.
//   - Budget a block: forward, Q 16 KB + 4 stages of K/V 16 KB = 80 KB at
//     d = 64, 32 KB + 3 x 32 KB = 128 KB at d = 128; dk/dv, K and V 32 KB +
//     4 stages of Q/dO/lse/delta 16.5 KB = 98 KB at d = 64, 64 KB + 3 x
//     32.5 KB = 162 KB at d = 128 (plus 1 KB of alignment). Registers:
//     setmaxnreg gives the producer 24 a thread and the consumers 240
//     (64,512 of the SM's 65,536), so one block an SM.
//   - Rounding points that moved from the JAX kernels: p = 2^(s c - m c)
//     with c = fl(scale * log2 e) in one FMA and ex2.approx (forward; the
//     JAX kernel rounds s * scale, subtracts and calls exp), and
//     p = 2^(s c - fl(lse * log2 e)) in dk/dv; each thread sums its share
//     of a row's p over all tiles, l = fma(l, alpha, sum), and the four
//     shares of a row are added once at the end (the JAX kernel adds each
//     tile's row sum). lse = fl(max(s) * scale) + log(l_safe), as before.
//   No atomics: every result is the same from run to run.
//
// f32 (the JAX tests' type and float32 configs), and the bf16 dq kernel:
// FlashAttention-2's layout, from the port's first design (the first half
// of this file). A block of 4 warps owns one 64-row tile: query rows for
// the forward and dq, key rows for dk/dv; each warp owns 16 of its rows. A
// loop over the other side's 64-row tiles takes the place of the TPU's
// sequential grid axis; the running max and sum and the f32 accumulators
// stay in registers, and causal tiles wholly above the diagonal are
// skipped. Tiles are staged in shared memory with 16-byte loads through the
// caller's strides, zero-padded to 32, 64 or 128 columns there. bf16 dq:
// mma.sync m16n8k16 with P and dS reused from the score fragments and B
// transposed by ldmatrix; f32: the products on the CUDA cores in full f32,
// no TF32, as the JAX side runs at precision "highest" (wgmma has no full
// f32 form). Multiplies that a sum follows use __fmul_rn, so nvcc contracts
// none of them into an FMA. fp16 is refused.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
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

// Element e of fragment j: from [DP / 8][4] (mma.sync's tiles) or from
// wgmma's flat accumulator, the same registers in the same order.
template <int J>
__device__ __forceinline__ float frag_at(const float (&acc)[J][4], int j,
                                         int e) {
  return acc[j][e];
}
template <int N>
__device__ __forceinline__ float frag_at(const float (&acc)[N], int j,
                                         int e) {
  return acc[4 * j + e];
}

// Write the warp's 16 x DP f32 fragments, times ``mul`` per fragment row
// (1 / l_safe in the forward: a divide), as T into rows row0 + (warp's
// rows) of an operand; rows past ``rows`` and columns past d are dropped.
template <typename T, int DP, bool kDivide, typename Acc>
__device__ __forceinline__ void store_rows(const Acc& acc,
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
      float x0 = frag_at(acc, j, hrow * 2);
      float x1 = frag_at(acc, j, hrow * 2 + 1);
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

// ============================================== Hopper: bf16 forward, dk/dv
//
// One producer warp (warp 8; warps 9-11 only give their registers back)
// and two consumer warpgroups (warps 0-3 and 4-7). The producer issues the
// TMA loads and nothing else; a consumer warpgroup owns 64 rows of the
// block's 128 and runs every product with wgmma.

constexpr int kHopperThreads = 384;
constexpr int kConsumerWarps = 8;
// 64 rows of 64 bf16 columns: 128 bytes a row, one swizzle span
constexpr int kSubTile64 = 64 * 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegRaw = -1e30f;          // masked raw score, and m's start

struct HopperParams {
  CUtensorMap tq, tk, tv, tdo;  // rank 4: (d, seq, head, batch)
  Operand o, dk, dv;            // written through the caller's strides
  float* lse;                   // [B * H, seq_q]
  const float* delta;           // [B * H, seq_q]
  int H, seq_q, seq_k, d, causal;
  float scale;                  // 1 / sqrt(d), the f32 the JAX kernels use
  float scale_log2;             // scale * log2(e), rounded once
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive, and expect ``bytes`` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the phase of parity ``parity``; a wait that
// never ends (a broken ring) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1 << 26)) __trap();
  }
}

// one box of a rank-4 tensor map into shared memory; rows and columns past
// the tensor's end arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across the
// fence, commit and wait instructions, which it cannot see them in
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128B-swizzled operand, as TMA lays
// it out: 128-byte rows, 8-row groups 1024 bytes apart. ``lbo`` is the byte
// offset between 64-column blocks of an MN-major operand (unused K-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d = A B^T (+ d if accumulate), A and B K-major in shared memory:
// m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(
    float (&d)[32], uint64_t da, uint64_t db,
    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A in registers (bf16 fragments), B MN-major in shared
// memory: m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d += A B, A in registers (bf16 fragments), B MN-major in shared
// memory: m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// The A operand of a product over this 64-column score tile's columns
// [16 kc, 16 kc + 16), rounded to bf16, from the f32 accumulator
// fragments (the same layout as mma.sync's: wgmma's accumulator of a
// 64 x N tile gives warp w rows 16 w + g and 16 w + g + 8, g = lane / 4,
// and element 4 j + e column 8 j + 2 (lane % 4) + e % 2 of row g + 8 (e / 2)).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&s)[32],
                                       int kc) {
  a[0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
  a[1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
  a[2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
  a[3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
}

// ---- forward: a block owns 128 query rows, a ring of 64-key K/V tiles

template <int DP>
struct FwdLayout {
  static constexpr int kSub = DP / 64;  // 64-column boxes of a row
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr int kQ = kSub * 2 * kSubTile64;  // 128 rows
  static constexpr int kKV = kSub * kSubTile64;     // 64 rows
  static constexpr int kStage = 2 * kKV;            // K then V
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_hopper(const __grid_constant__ HopperParams p) {
  using L = FwdLayout<DP>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 128B-swizzled tiles start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::kBars, empty = full + 8 * S,
                 qbar = empty + 8 * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  // causal: the longest query tiles (the last rows) are launched first
  const int q0 = 128 * (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y);
  int nk = (p.seq_k + 63) / 64;
  if (p.causal) nk = min(nk, (q0 + 127) / 64 + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      const int b = bh / p.H, h = bh % p.H;
      mbar_expect_tx(qbar, L::kQ);
      for (int c = 0; c < L::kSub; ++c) {
        tma_load(base + c * 2 * kSubTile64, &p.tq, qbar, 64 * c, q0, h, b);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % S;
        mbar_wait(empty + 8 * s, ((j / S) & 1) ^ 1);
        const uint32_t kt = base + L::kQ + s * L::kStage, vt = kt + L::kKV;
        mbar_expect_tx(full + 8 * s, L::kStage);
        for (int c = 0; c < L::kSub; ++c) {
          tma_load(kt + c * kSubTile64, &p.tk, full + 8 * s, 64 * c, 64 * j,
                   h, b);
          tma_load(vt + c * kSubTile64, &p.tv, full + 8 * s, 64 * c, 64 * j,
                   h, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp >> 2, wq = warp & 3;
    const int r0 = q0 + 64 * wg;  // the warpgroup's first query row
    const float c2 = p.scale_log2;
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kNegRaw, kNegRaw};  // running max of the raw scores
    float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums
    mbar_wait(qbar, 0);
    // the warpgroup's 64 rows of Q: rows 64 wg of each 128-row box
    const uint32_t qa = base + wg * kSubTile64;

    for (int j = 0; j < nk; ++j) {
      const int s = j % S, k0 = 64 * j;
      const uint32_t kt = base + L::kQ + s * L::kStage, vt = kt + L::kKV;
      mbar_wait(full + 8 * s, (j / S) & 1);
      // causal: a key tile wholly above this warpgroup's rows adds nothing
      if (!p.causal || k0 <= r0 + 63) {
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int c = kk / 4, o = (kk % 4) * 32;
          wgmma_ss_n64(sc, sw128_desc(qa + c * 2 * kSubTile64 + o, 16),
                       sw128_desc(kt + c * kSubTile64 + o, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        // masks only where the tile crosses the diagonal or the keys' end
        const bool edge =
            (p.causal && k0 + 63 > r0) || k0 + 64 > p.seq_k;
        if (edge) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int qpos = r0 + wq * 16 + frag_row(i & 3);
            const int kpos = k0 + frag_col(i >> 2, i & 3);
            if (kpos >= p.seq_k || (p.causal && qpos < kpos)) sc[i] = kNegRaw;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        }
        float mc[2], alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          mc[r] = mx[r] * c2;
          alpha[r] = ex2(fmaf(m[r], c2, -mc[r]));
          m[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          float e = ex2(fmaf(sc[i], c2, -mc[r]));
          if (edge && sc[i] == kNegRaw) e = 0.0f;
          sc[i] = e;
          rs[r] += e;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], rs[r]);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) a_frag(pa[kc], sc, kc);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          // V is keys x d with d contiguous: MN-major, 16 keys a step
          wgmma_rs<DP>(acc, pa[kc], sw128_desc(vt + kc * 2048, kSubTile64));
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    float l_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) l_safe[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row0 = r0 + wq * 16;
    store_rows<__nv_bfloat16, DP, true>(acc, l_safe, p.o, bh, p.H, row0,
                                        p.seq_q, p.d);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + frag_row(2 * r);
        if (qpos < p.seq_q) {
          // m in the scores' natural units: fl(max(s) * scale) is the max
          // of the rounded fl(s * scale), as the JAX kernel takes it
          p.lse[static_cast<long long>(bh) * p.seq_q + qpos] =
              __fadd_rn(__fmul_rn(m[r], p.scale), logf(l_safe[r]));
        }
      }
    }
  }
}

// ---- dk/dv: a block owns 128 keys (K, V resident), a ring of 64-query
// Q/dO tiles with their lse and delta

template <int DP>
struct DkvLayout {
  static constexpr int kSub = DP / 64;
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr int kKV = kSub * 2 * kSubTile64;  // 128 rows of K or V
  static constexpr int kQ = kSub * kSubTile64;       // 64 rows of Q or dO
  static constexpr int kStage = 2 * kQ;              // Q then dO
  static constexpr int kVec = 2 * kKV + kStages * kStage;  // lse, delta
  static constexpr int kBars = kVec + kStages * 2 * 64 * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dkv_hopper(const __grid_constant__ HopperParams p) {
  using L = DkvLayout<DP>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  float* const vec = reinterpret_cast<float*>(gbase + L::kVec);
  const uint32_t full = base + L::kBars, empty = full + 8 * S,
                 kvbar = empty + 8 * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int k0 = 128 * blockIdx.y;  // causal: key tile 0 has the most work
  const int nq = (p.seq_q + 63) / 64;
  // the first query tile whose last row reaches this block's first key
  const int q_first = p.causal ? k0 / 64 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps) {
      const int b = bh / p.H, h = bh % p.H;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * L::kKV);
        for (int c = 0; c < L::kSub; ++c) {
          tma_load(base + c * 2 * kSubTile64, &p.tk, kvbar, 64 * c, k0, h, b);
          tma_load(base + L::kKV + c * 2 * kSubTile64, &p.tv, kvbar, 64 * c,
                   k0, h, b);
        }
      }
      const long long row = static_cast<long long>(bh) * p.seq_q;
      for (int qi = q_first; qi < nq; ++qi) {
        const int it = qi - q_first, s = it % S, q0 = 64 * qi;
        mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
        float* lse2 = vec + s * 128;
        float* dl = lse2 + 64;
#pragma unroll
        for (int i = lane; i < 64; i += 32) {
          const bool in = q0 + i < p.seq_q;
          lse2[i] = in ? p.lse[row + q0 + i] * kLog2e : 0.0f;
          dl[i] = in ? p.delta[row + q0 + i] : 0.0f;
        }
        if (lane == 0) {
          const uint32_t qt = base + 2 * L::kKV + s * L::kStage,
                         dt = qt + L::kQ;
          mbar_expect_tx(full + 8 * s, L::kStage);
          for (int c = 0; c < L::kSub; ++c) {
            tma_load(qt + c * kSubTile64, &p.tq, full + 8 * s, 64 * c, q0, h,
                     b);
            tma_load(dt + c * kSubTile64, &p.tdo, full + 8 * s, 64 * c, q0,
                     h, b);
          }
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp >> 2, wq = warp & 3;
    const int kw0 = k0 + 64 * wg;  // the warpgroup's first key
    const float c2 = p.scale_log2;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
    mbar_wait(kvbar, 0);
    const uint32_t ka = base + wg * kSubTile64;
    const uint32_t va = base + L::kKV + wg * kSubTile64;

    for (int qi = q_first; qi < nq; ++qi) {
      const int it = qi - q_first, s = it % S, q0 = 64 * qi;
      const uint32_t qt = base + 2 * L::kKV + s * L::kStage, dt = qt + L::kQ;
      const float* lse2 = vec + s * 128;
      const float* dl = lse2 + 64;
      mbar_wait(full + 8 * s, (it / S) & 1);
      // causal: a query tile wholly before this warpgroup's keys adds
      // nothing
      if (!p.causal || q0 + 63 >= kw0) {
        // transposed scores: rows are the warpgroup's keys, columns the
        // tile's queries
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int c = kk / 4, o = (kk % 4) * 32;
          wgmma_ss_n64(st, sw128_desc(ka + c * 2 * kSubTile64 + o, 16),
                       sw128_desc(qt + c * kSubTile64 + o, 16), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int c = kk / 4, o = (kk % 4) * 32;
          wgmma_ss_n64(dpt, sw128_desc(va + c * 2 * kSubTile64 + o, 16),
                       sw128_desc(dt + c * kSubTile64 + o, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(st);
        // masks only on the diagonal tile and past the queries' end (keys
        // past the end give rows that are never stored)
        const bool edge = (p.causal && q0 < kw0 + 64) || q0 + 64 > p.seq_q;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          st[i] = ex2(fmaf(st[i], c2, -lse2[frag_col(i >> 2, i & 3)]));
        }
        if (edge) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int qpos = q0 + frag_col(i >> 2, i & 3);
            const int kpos = kw0 + wq * 16 + frag_row(i & 3);
            if (qpos >= p.seq_q || (p.causal && qpos < kpos)) st[i] = 0.0f;
          }
        }
        wgmma_wait<0>();
        reg_fence(dpt);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = frag_col(i >> 2, i & 3);
          // ds = (p * (dp - delta)) * scale, rounded to bf16 below
          dpt[i] = __fmul_rn(__fmul_rn(st[i], __fsub_rn(dpt[i], dl[col])),
                             p.scale);
        }
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          a_frag(pa[kc], st, kc);
          a_frag(da[kc], dpt, kc);
        }
        reg_fence(dv);
        reg_fence(dk);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          // dO and Q are queries x d with d contiguous: MN-major, 16
          // queries a step
          wgmma_rs<DP>(dv, pa[kc], sw128_desc(dt + kc * 2048, kSubTile64));
        }
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          wgmma_rs<DP>(dk, da[kc], sw128_desc(qt + kc * 2048, kSubTile64));
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    const float one[2] = {1.0f, 1.0f};
    const int row0 = kw0 + wq * 16;
    store_rows<__nv_bfloat16, DP, false>(dk, one, p.dk, bh, p.H, row0,
                                         p.seq_k, p.d);
    store_rows<__nv_bfloat16, DP, false>(dv, one, p.dv, bh, p.H, row0,
                                         p.seq_k, p.d);
  }
}

// ------------------------------------------------------------------ host

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// codes past the CUDA runtime's: a tensor map that cannot be encoded
constexpr int kErrNoEncoder = 10000;
constexpr int kErrTensorMap = 10001;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so that the
// library links against nothing but the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [B, H, seq, d] operand with unit stride along d as a rank-4 map
// over (d, seq, head, batch), boxes of 64 columns x ``rows``, 128B swizzle;
// out-of-bounds elements arrive as zeros.
int tensor_map(CUtensorMap* map, const void* ptr, const long long* strides,
               int B, int H, int seq, int d, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// The kernel of one call: its function, dynamic shared memory and threads.
struct Choice {
  const void* fn;
  int bytes;
  int threads;
};

template <typename T, int DP>
Choice simt_choice(Which which) {
  if constexpr (std::is_same<T, float>::value) {
    if (which == kFwd)
      return {reinterpret_cast<const void*>(flash_fwd_kernel<T, DP>),
              tiles_bytes<T, DP>(3), kThreads};
    if (which == kDkv)
      return {reinterpret_cast<const void*>(flash_bwd_dkv_kernel<T, DP>),
              tiles_bytes<T, DP>(4), kThreads};
  }
  return {reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, DP>),
          tiles_bytes<T, DP>(4), kThreads};
}

template <int DP>
Choice hopper_choice(Which which) {
  if (which == kFwd)
    return {reinterpret_cast<const void*>(flash_fwd_hopper<DP>),
            FwdLayout<DP>::kBytes, kHopperThreads};
  return {reinterpret_cast<const void*>(flash_bwd_dkv_hopper<DP>),
          DkvLayout<DP>::kBytes, kHopperThreads};
}

// bf16 forward and dk/dv: the Hopper kernels (64 or 128 columns); every
// other call: the CUDA-core / mma.sync kernels (32, 64 or 128 columns)
Choice choose(Which which, int dtype, int d) {
  if (dtype == 0 && which != kDq) {
    return d <= 64 ? hopper_choice<64>(which) : hopper_choice<128>(which);
  }
  if (dtype == 0) {
    if (d <= 32) return simt_choice<__nv_bfloat16, 32>(which);
    if (d <= 64) return simt_choice<__nv_bfloat16, 64>(which);
    return simt_choice<__nv_bfloat16, 128>(which);
  }
  if (d <= 32) return simt_choice<float, 32>(which);
  if (d <= 64) return simt_choice<float, 64>(which);
  return simt_choice<float, 128>(which);
}

Operand operand(const void* p, const long long* strides) {
  Operand t;
  t.p = const_cast<void*>(p);
  t.sb = strides[0];
  t.sh = strides[1];
  t.ss = strides[2];
  return t;
}

bool bad_shape(int B, int H, int seq_q, int seq_k, int d, int dtype) {
  // the wrapper checks these; a bad call must not reach the kernels
  return d < 8 || d > 128 || d % 8 != 0 || B < 1 || H < 1 || seq_q < 1 ||
         seq_k < 1 || B * H > 65535 || (dtype != 0 && dtype != 1);
}

int launch(const Choice& c, void** args, dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernel(c.fn, grid, dim3(c.threads), args, c.bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int run_simt(Which which, const Args& a, int B, int dtype, void* stream) {
  const Choice c = choose(which, dtype, a.d);
  const int rows = which == kDkv ? a.seq_k : a.seq_q;
  Args copy = a;
  void* args[] = {&copy};
  return launch(c, args, dim3((rows + kBlock - 1) / kBlock, B * a.H),
                static_cast<cudaStream_t>(stream));
}

HopperParams hopper_params(int H, int seq_q, int seq_k, int d, int causal,
                           float scale) {
  HopperParams p;
  memset(&p, 0, sizeof(p));
  p.H = H;
  p.seq_q = seq_q;
  p.seq_k = seq_k;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
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
// returns the CUDA error of its launch (0 on success), or a code of this
// library that mxtt_flash_error_string names.

int mxtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* strides, int B, int H,
                   int seq_q, int seq_k, int d, int causal, float scale,
                   int dtype, void* stream) {
  if (bad_shape(B, H, seq_q, seq_k, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    Args a = base_args(H, seq_q, seq_k, d, causal, scale);
    a.q = operand(q, strides);
    a.k = operand(k, strides + 3);
    a.v = operand(v, strides + 6);
    a.o = operand(o, strides + 9);
    a.lse = lse;
    return run_simt(kFwd, a, B, dtype, stream);
  }
  HopperParams p = hopper_params(H, seq_q, seq_k, d, causal, scale);
  int err = tensor_map(&p.tq, q, strides, B, H, seq_q, d, 128);
  if (!err) err = tensor_map(&p.tk, k, strides + 3, B, H, seq_k, d, 64);
  if (!err) err = tensor_map(&p.tv, v, strides + 6, B, H, seq_k, d, 64);
  if (err) return err;
  p.o = operand(o, strides + 9);
  p.lse = lse;
  void* args[] = {&p};
  return launch(choose(kFwd, dtype, d), args,
                dim3(B * H, (seq_q + 127) / 128),
                static_cast<cudaStream_t>(stream));
}

int mxtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, const long long* strides, int B, int H,
                      int seq_q, int seq_k, int d, int causal, float scale,
                      int dtype, void* stream) {
  if (bad_shape(B, H, seq_q, seq_k, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = base_args(H, seq_q, seq_k, d, causal, scale);
  a.q = operand(q, strides);
  a.k = operand(k, strides + 3);
  a.v = operand(v, strides + 6);
  a.dout = operand(dout, strides + 9);
  a.dq = operand(dq, strides + 12);
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  return run_simt(kDq, a, B, dtype, stream);
}

int mxtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* strides, int B,
                       int H, int seq_q, int seq_k, int d, int causal,
                       float scale, int dtype, void* stream) {
  if (bad_shape(B, H, seq_q, seq_k, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    Args a = base_args(H, seq_q, seq_k, d, causal, scale);
    a.q = operand(q, strides);
    a.k = operand(k, strides + 3);
    a.v = operand(v, strides + 6);
    a.dout = operand(dout, strides + 9);
    a.dk = operand(dk, strides + 12);
    a.dv = operand(dv, strides + 15);
    a.lse = const_cast<float*>(lse);
    a.delta = delta;
    return run_simt(kDkv, a, B, dtype, stream);
  }
  HopperParams p = hopper_params(H, seq_q, seq_k, d, causal, scale);
  int err = tensor_map(&p.tq, q, strides, B, H, seq_q, d, 64);
  if (!err) err = tensor_map(&p.tk, k, strides + 3, B, H, seq_k, d, 128);
  if (!err) err = tensor_map(&p.tv, v, strides + 6, B, H, seq_k, d, 128);
  if (!err) err = tensor_map(&p.tdo, dout, strides + 9, B, H, seq_q, d, 64);
  if (err) return err;
  p.dk = operand(dk, strides + 12);
  p.dv = operand(dv, strides + 15);
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  void* args[] = {&p};
  return launch(choose(kDkv, dtype, d), args,
                dim3(B * H, (seq_k + 127) / 128),
                static_cast<cudaStream_t>(stream));
}

// The compiled kernel a call of ``which`` (0 forward, 1 dq, 2 dk/dv) at
// ``dtype`` and head_dim ``d`` launches: out[0] registers a thread, out[1]
// static and out[2] dynamic shared memory a block (bytes), out[3] threads
// a block, out[4] local memory a thread (bytes: spills). Returns the CUDA
// error of the query.
int mxtt_flash_kernel_attributes(int which, int dtype, int d, int* out) {
  if (which < 0 || which > 2 || bad_shape(1, 1, 1, 1, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Choice c = choose(static_cast<Which>(which), dtype, d);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, c.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = c.bytes;
  out[3] = c.threads;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

const char* mxtt_flash_error_string(int code) {
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused an operand (its strides must be "
           "multiples of 16 bytes, its address 16-byte aligned)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
