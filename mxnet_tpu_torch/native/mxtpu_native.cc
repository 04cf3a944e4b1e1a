// Native data pipeline of mxnet_tpu_torch: the port's copy of the JAX
// package's mxnet_tpu/native/mxtpu_native.cc, with a baseline JPEG codec of
// its own in place of libjpeg.
//
// A pool of worker threads reads RecordIO-framed JPEG records, decodes them,
// augments them (resize the shorter side / random scale / size clamps /
// crop / mirror / mean / contrast / illumination / scale) and assembles
// float32 or uint8 NCHW or NHWC batches, delivered in order through a
// bounded queue. Batches equal the JAX package's pipeline's bit for bit:
// the same tickets, the same per-worker mt19937 streams, the same
// fixed-point resize and float normalisation.
//
// The codec (namespace jpeg) decodes baseline, extended-sequential and
// progressive JPEG, Huffman or arithmetic coded (SOF0-2, SOF9-10), as
// libjpeg(-turbo) does with its defaults (islow IDCT, fancy upsampling, its
// YCbCr tables), bit for bit, and encodes baseline JPEG as libjpeg's
// jpeg_set_defaults + jpeg_set_quality(q, TRUE) do (islow DCT, standard
// Huffman tables, 4:2:0 for colour). Lossless and hierarchical files and
// 12-bit samples are refused, as the 8-bit libjpeg refuses them, and so is
// CMYK, which libjpeg does not convert to RGB (the caller falls back).
//
// File format (mxnet_tpu_torch/recordio.py is the Python writer):
//   per record: u32 magic 'CREC' (0x54524543 LE), u32 crc32(payload),
//               u64 length, payload, zero-pad to 8 bytes.
//   payload (image records): u32 flag, f32 label, u64 id, u64 id2,
//               [flag>0: f32 label vector], image bytes (JPEG here).
//
// C ABI only; loaded from Python through ctypes.

#include <algorithm>
#include <atomic>
#include <climits>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <zlib.h>

namespace jpeg {

// zigzag position -> natural (row-major) position
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ------------------------------------------------- islow fixed-point DCTs
// libjpeg's jidctint.c / jfdctint.c constants (CONST_BITS 13)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int64_t Descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: clamp(x + 128, 0, 255) for x within
// [-512, 512), and its table's wrap-around (masked by 1023) outside.
inline uint8_t IdctLimit(int64_t x) {
  int i = int(x) & 1023;
  if (i < 128) return uint8_t(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return uint8_t(i - 896);
}

// jpeg_idct_islow: dequantised 8x8 inverse DCT into 8 rows of `out`.
void IdctIslow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
               size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (int(in[0]) * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16], z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = int(Descale(tmp10 + tmp3, n));
    w[56] = int(Descale(tmp10 - tmp3, n));
    w[8] = int(Descale(tmp11 + tmp2, n));
    w[48] = int(Descale(tmp11 - tmp2, n));
    w[16] = int(Descale(tmp12 + tmp1, n));
    w[40] = int(Descale(tmp12 - tmp1, n));
    w[24] = int(Descale(tmp13 + tmp0, n));
    w[32] = int(Descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = IdctLimit(Descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = IdctLimit(Descale(tmp10 + tmp3, n));
    o[7] = IdctLimit(Descale(tmp10 - tmp3, n));
    o[1] = IdctLimit(Descale(tmp11 + tmp2, n));
    o[6] = IdctLimit(Descale(tmp11 - tmp2, n));
    o[2] = IdctLimit(Descale(tmp12 + tmp1, n));
    o[5] = IdctLimit(Descale(tmp12 - tmp1, n));
    o[3] = IdctLimit(Descale(tmp13 + tmp0, n));
    o[4] = IdctLimit(Descale(tmp13 - tmp0, n));
  }
}

// jpeg_fdct_islow on samples already centred (x - 128); the result is
// scaled up by 8, as libjpeg's.
void FdctIslow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + r * 8;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    const int n = kConstBits - kPass1Bits;
    p[2] = int(Descale(z1 + tmp13 * F0_765, n));
    p[6] = int(Descale(z1 + tmp12 * -F1_847, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[7] = int(Descale(tmp4 + z1 + z3, n));
    p[5] = int(Descale(tmp5 + z2 + z4, n));
    p[3] = int(Descale(tmp6 + z2 + z3, n));
    p[1] = int(Descale(tmp7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(Descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(Descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    const int n = kConstBits + kPass1Bits;
    p[16] = int(Descale(z1 + tmp13 * F0_765, n));
    p[48] = int(Descale(z1 + tmp12 * -F1_847, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[56] = int(Descale(tmp4 + z1 + z3, n));
    p[40] = int(Descale(tmp5 + z2 + z4, n));
    p[24] = int(Descale(tmp6 + z2 + z3, n));
    p[8] = int(Descale(tmp7 + z1 + z4, n));
  }
}

// ---------------------------------------------------------- colour tables
// jdcolor.c build_ycc_rgb_table and jccolor.c rgb_ycc_start (SCALEBITS 16)
constexpr int kScaleBits = 16;
constexpr int64_t kHalf = int64_t(1) << (kScaleBits - 1);
constexpr int64_t Fix(double x) {
  return int64_t(x * double(int64_t(1) << kScaleBits) + 0.5);
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  int64_t r_y[256], g_y[256], b_y[256], r_cb[256], g_cb[256], b_cb[256],
      g_cr[256], b_cr[256];  // b_cb doubles as r_cr (both FIX(0.5))
  ColorTables() {
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((Fix(1.40200) * x + kHalf) >> kScaleBits);
      cb_b[i] = int((Fix(1.77200) * x + kHalf) >> kScaleBits);
      cr_g[i] = -Fix(0.71414) * x;
      cb_g[i] = -Fix(0.34414) * x + kHalf;
      r_y[i] = Fix(0.29900) * i;
      g_y[i] = Fix(0.58700) * i;
      b_y[i] = Fix(0.11400) * i + kHalf;
      r_cb[i] = -Fix(0.16874) * i;
      g_cb[i] = -Fix(0.33126) * i;
      // B=>Cb and R=>Cr are the same; with the offset and the -1 fudge
      b_cb[i] = Fix(0.5) * i + (int64_t(128) << kScaleBits) + kHalf - 1;
      g_cr[i] = -Fix(0.41869) * i;
      b_cr[i] = -Fix(0.08131) * i;
    }
  }
};

const ColorTables& Tables() {
  static const ColorTables t;
  return t;
}

inline uint8_t Clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ------------------------------------------------------------- decoding
struct HuffTable {
  bool present = false;
  uint8_t counts[17] = {};
  uint8_t symbols[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t lookup[1 << 9] = {};  // (length << 8) | symbol; 0: longer code

  bool Build() {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += counts[l];
    if (total > 256) return false;
    std::memset(lookup, 0, sizeof(lookup));
    int last = 0;
    for (int l = 1; l <= 16; ++l)
      if (counts[l]) last = l;
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            lookup[(code << shift) | j] = uint16_t((l << 8) | symbols[k]);
        }
      }
      maxcode[l] = counts[l] ? code - 1 : -1;
      // libjpeg's JERR_BAD_HUFF_TABLE: no all-ones code
      if (l <= last && code >= (1 << l)) return false;
      code <<= 1;
    }
    maxcode[17] = INT32_MAX;
    present = true;
    return true;
  }
};

// Entropy-coded bits with byte stuffing; a marker stops the reads (zeros
// are fed after it, as libjpeg does), and `p` stays on the marker's 0xFF.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int bits = 0;
  int fake = 0;  // bits of acc fed after a marker or the end of the data
  bool marker = false;

  void Fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      bool real = false;
      if (!marker && p < end) {
        if (*p == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0x00) {
            byte = 0xFF;
            real = true;
            p = q + 1;
          } else {
            marker = true;
            p = q - 1;
          }
        } else {
          byte = *p++;
          real = true;
        }
      }
      if (!real) fake += 8;
      acc |= uint64_t(byte) << (56 - bits);
      bits += 8;
    }
  }
  inline uint32_t Get(int n) {  // 0 < n <= 16
    if (bits < n) Fill();
    uint32_t v = uint32_t(acc >> (64 - n));
    acc <<= n;
    bits -= n;
    return v;
  }
  // Restart: drop the buffered bits and step over the next RSTn marker.
  bool Restart(int expect) {
    acc = 0;
    bits = 0;
    fake = 0;
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF))
        ++p;
    }
    marker = false;
    if (p + 1 >= end || p[1] != 0xD0 + expect) return false;
    p += 2;
    return true;
  }
  // Were bits past a marker consumed (the zeros Fill feeds after it)?
  // A complete scan never needs them: libjpeg's "premature end of data".
  bool Overran() const { return fake > bits; }
  inline int Decode(const HuffTable& t) {
    if (bits < 16) Fill();
    uint16_t e = t.lookup[acc >> 55];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      bits -= l;
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int32_t code = int32_t(acc >> (64 - l));
      if (code <= t.maxcode[l]) {
        acc <<= l;
        bits -= l;
        return t.symbols[code + t.valoffset[l]];
      }
    }
    return -1;  // a bad code
  }
};

inline int Extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? int(v) - (1 << s) + 1 : int(v);
}

// ------------------------------------- arithmetic decoding (jdarith.c)
// libjpeg's jaricom.c: the QM coder's probability estimation states of the
// JPEG standard's Table D.2, packed as Qe << 16 | next state after an MPS
// << 8 | switch of the MPS on an LPS << 7 | next state after an LPS, and a
// 114th state of fixed probability 0.5 (ITU-T T.851) that the signs of AC
// coefficients and the DC refinement bits use.
constexpr int32_t Qm(int32_t qe, int nl, int nm, int sw) {
  return (qe << 16) | (nm << 8) | (sw << 7) | nl;
}
constexpr int32_t kQmStates[114] = {
    Qm(0x5a1d, 1, 1, 1),     Qm(0x2586, 14, 2, 0),    Qm(0x1114, 16, 3, 0),
    Qm(0x080b, 18, 4, 0),    Qm(0x03d8, 20, 5, 0),    Qm(0x01da, 23, 6, 0),
    Qm(0x00e5, 25, 7, 0),    Qm(0x006f, 28, 8, 0),    Qm(0x0036, 30, 9, 0),
    Qm(0x001a, 33, 10, 0),   Qm(0x000d, 35, 11, 0),   Qm(0x0006, 9, 12, 0),
    Qm(0x0003, 10, 13, 0),   Qm(0x0001, 12, 13, 0),   Qm(0x5a7f, 15, 15, 1),
    Qm(0x3f25, 36, 16, 0),   Qm(0x2cf2, 38, 17, 0),   Qm(0x207c, 39, 18, 0),
    Qm(0x17b9, 40, 19, 0),   Qm(0x1182, 42, 20, 0),   Qm(0x0cef, 43, 21, 0),
    Qm(0x09a1, 45, 22, 0),   Qm(0x072f, 46, 23, 0),   Qm(0x055c, 48, 24, 0),
    Qm(0x0406, 49, 25, 0),   Qm(0x0303, 51, 26, 0),   Qm(0x0240, 52, 27, 0),
    Qm(0x01b1, 54, 28, 0),   Qm(0x0144, 56, 29, 0),   Qm(0x00f5, 57, 30, 0),
    Qm(0x00b7, 59, 31, 0),   Qm(0x008a, 60, 32, 0),   Qm(0x0068, 62, 33, 0),
    Qm(0x004e, 63, 34, 0),   Qm(0x003b, 32, 35, 0),   Qm(0x002c, 33, 9, 0),
    Qm(0x5ae1, 37, 37, 1),   Qm(0x484c, 64, 38, 0),   Qm(0x3a0d, 65, 39, 0),
    Qm(0x2ef1, 67, 40, 0),   Qm(0x261f, 68, 41, 0),   Qm(0x1f33, 69, 42, 0),
    Qm(0x19a8, 70, 43, 0),   Qm(0x1518, 72, 44, 0),   Qm(0x1177, 73, 45, 0),
    Qm(0x0e74, 74, 46, 0),   Qm(0x0bfb, 75, 47, 0),   Qm(0x09f8, 77, 48, 0),
    Qm(0x0861, 78, 49, 0),   Qm(0x0706, 79, 50, 0),   Qm(0x05cd, 48, 51, 0),
    Qm(0x04de, 50, 52, 0),   Qm(0x040f, 50, 53, 0),   Qm(0x0363, 51, 54, 0),
    Qm(0x02d4, 52, 55, 0),   Qm(0x025c, 53, 56, 0),   Qm(0x01f8, 54, 57, 0),
    Qm(0x01a4, 55, 58, 0),   Qm(0x0160, 56, 59, 0),   Qm(0x0125, 57, 60, 0),
    Qm(0x00f6, 58, 61, 0),   Qm(0x00cb, 59, 62, 0),   Qm(0x00ab, 61, 63, 0),
    Qm(0x008f, 61, 32, 0),   Qm(0x5b12, 65, 65, 1),   Qm(0x4d04, 80, 66, 0),
    Qm(0x412c, 81, 67, 0),   Qm(0x37d8, 82, 68, 0),   Qm(0x2fe8, 83, 69, 0),
    Qm(0x293c, 84, 70, 0),   Qm(0x2379, 86, 71, 0),   Qm(0x1edf, 87, 72, 0),
    Qm(0x1aa9, 87, 73, 0),   Qm(0x174e, 72, 74, 0),   Qm(0x1424, 72, 75, 0),
    Qm(0x119c, 74, 76, 0),   Qm(0x0f6b, 74, 77, 0),   Qm(0x0d51, 75, 78, 0),
    Qm(0x0bb6, 77, 79, 0),   Qm(0x0a40, 77, 48, 0),   Qm(0x5832, 80, 81, 1),
    Qm(0x4d1c, 88, 82, 0),   Qm(0x438e, 89, 83, 0),   Qm(0x3bdd, 90, 84, 0),
    Qm(0x34ee, 91, 85, 0),   Qm(0x2eae, 92, 86, 0),   Qm(0x299a, 93, 87, 0),
    Qm(0x2516, 86, 71, 0),   Qm(0x5570, 88, 89, 1),   Qm(0x4ca9, 95, 90, 0),
    Qm(0x44d9, 96, 91, 0),   Qm(0x3e22, 97, 92, 0),   Qm(0x3824, 99, 93, 0),
    Qm(0x32b4, 99, 94, 0),   Qm(0x2e17, 93, 86, 0),   Qm(0x56a8, 95, 96, 1),
    Qm(0x4f46, 101, 97, 0),  Qm(0x47e5, 102, 98, 0),  Qm(0x41cf, 103, 99, 0),
    Qm(0x3c3d, 104, 100, 0), Qm(0x375e, 99, 93, 0),   Qm(0x5231, 105, 102, 0),
    Qm(0x4c0f, 106, 103, 0), Qm(0x4639, 107, 104, 0), Qm(0x415e, 103, 99, 0),
    Qm(0x5627, 105, 106, 1), Qm(0x50e7, 108, 107, 0), Qm(0x4b85, 109, 103, 0),
    Qm(0x5597, 110, 109, 0), Qm(0x504f, 111, 107, 0), Qm(0x5a10, 110, 111, 1),
    Qm(0x5522, 112, 109, 0), Qm(0x59eb, 112, 111, 1), Qm(0x5a1d, 113, 113, 0)};
constexpr uint8_t kFixedBin = 113;

// The QM decoder's registers as jdarith.c keeps them: C holds the base of
// the coding interval and the input bits not yet used, their cut floating
// with CT. A marker met in the data is legal here (unlike Huffman data):
// libjpeg then feeds zeros until the scan ends, and so does this reader,
// with `p` left on the marker's 0xFF. The end of the data counts as a
// marker (libjpeg's source inserts an EOI there).
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: the two bytes that first fill C are still to come
  bool marker = false;

  int Byte() {
    if (marker) return 0;
    if (p >= end) {
      marker = true;
      return 0;
    }
    if (*p != 0xFF) return *p++;
    const uint8_t* q = p + 1;
    while (q < end && *q == 0xFF) ++q;  // fill bytes
    if (q < end && *q == 0x00) {        // a stuffed zero
      p = q + 1;
      return 0xFF;
    }
    marker = true;
    p = q - 1;
    return 0;
  }

  // arith_decode: one binary decision with the adaptive state *st (its
  // top bit the MPS), the state updated (sections D.2.4-D.2.6)
  int Decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalise, reading bytes as CT runs out
      if (--ct < 0) {
        c = (c << 8) | Byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // C now holds 2 bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kQmStates[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS after all
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional exchange: an LPS
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // process_restart: step over the next RSTn marker (libjpeg's
  // read_restart_marker skips what the decoder left before it) and start
  // the decoder afresh; the caller resets the statistics.
  bool Restart(int expect) {
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF))
        ++p;
    }
    marker = false;
    c = a = 0;
    ct = -16;
    if (p + 1 >= end || p[1] != 0xD0 + expect) return false;
    p += 2;
    return true;
  }
};

struct Component {
  int id, h, v, tq;
  int dw, dh;          // downsampled width and height
  int wb, hb;          // width and height in blocks
  int stride, rows;    // plane size, covering every MCU
  std::vector<uint8_t> plane;
  int dc_table = 0, ac_table = 0;
  int pred = 0;
  int dc_context = 0;  // arithmetic DC: the statistics bin of the last diff
  // progressive files: the whole image's coefficients (jdcoefct.c's
  // whole-image buffer, MCU-padded, `stride / 8` blocks a row, 64 a block,
  // natural order), the quantiser latched at the component's first scan
  // (jdinput.c latch_quant_tables) and each coefficient's known low bit
  // (cinfo->coef_bits: -1 until a scan carried it)
  std::vector<int16_t> coef;
  bool latched = false;
  uint16_t qt[64] = {};
  int coef_bits[64];
};

struct Decoder {
  Decoder(const uint8_t* b, size_t n) : buf(b), len(n) {
    std::fill(arith_dc_l, arith_dc_l + 16, 0);
    std::fill(arith_dc_u, arith_dc_u + 16, 1);
    std::fill(arith_ac_k, arith_ac_k + 16, 5);
  }
  const uint8_t* buf;
  size_t len;
  size_t pos = 0;
  uint16_t quant[4][64] = {};
  bool has_quant[4] = {};
  HuffTable dc[4], ac[4];
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false, progressive = false, arith = false, eoi = false;
  int eobrun = 0;  // progressive AC scans: blocks left in the band's EOB run
  std::vector<Component> comps;
  // arithmetic coding: each table's conditioning from DAC (libjpeg's
  // defaults at SOI: L = 0, U = 1, Kx = 5) and jdarith.c's statistics bins
  uint8_t arith_dc_l[16], arith_dc_u[16], arith_ac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = kFixedBin;

  bool U16(uint32_t* v) {
    if (pos + 2 > len) return false;
    *v = (uint32_t(buf[pos]) << 8) | buf[pos + 1];
    pos += 2;
    return true;
  }

  bool Segment(const uint8_t** seg, size_t* n) {
    uint32_t l;
    if (!U16(&l) || l < 2 || pos + (l - 2) > len) return false;
    *seg = buf + pos;
    *n = l - 2;
    pos += l - 2;
    return true;
  }

  bool ReadDQT(const uint8_t* s, size_t n) {
    size_t i = 0;
    while (i < n) {
      int pq = s[i] >> 4, tq = s[i] & 15;
      ++i;
      if (tq > 3 || pq > 1 || i + 64 * (pq + 1) > n) return false;
      for (int k = 0; k < 64; ++k) {
        uint16_t q = pq ? uint16_t((s[i] << 8) | s[i + 1]) : s[i];
        i += pq + 1;
        quant[tq][kNatural[k]] = q;
      }
      has_quant[tq] = true;
    }
    return true;
  }

  bool ReadDHT(const uint8_t* s, size_t n) {
    size_t i = 0;
    while (i < n) {
      if (i + 17 > n) return false;
      int tc = s[i] >> 4, th = s[i] & 15;
      if (tc > 1 || th > 3) return false;
      HuffTable& t = tc ? ac[th] : dc[th];
      int total = 0;
      t.counts[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        t.counts[l] = s[i + l];
        total += t.counts[l];
      }
      i += 17;
      if (total > 256 || i + total > n) return false;
      std::memcpy(t.symbols, s + i, total);
      i += total;
      if (!t.Build()) return false;
    }
    return true;
  }

  // jdmarker.c get_dac: (Tc << 4 | Tb, value) pairs
  bool ReadDAC(const uint8_t* s, size_t n) {
    if (n % 2) return false;
    for (size_t i = 0; i < n; i += 2) {
      const int index = s[i], val = s[i + 1];
      if (index >= 32) return false;
      if (index >= 16) {
        arith_ac_k[index - 16] = uint8_t(val);
      } else {
        arith_dc_l[index] = uint8_t(val & 15);
        arith_dc_u[index] = uint8_t(val >> 4);
        if (arith_dc_l[index] > arith_dc_u[index]) return false;
      }
    }
    return true;
  }

  bool ReadSOF(const uint8_t* s, size_t n) {
    if (frame || n < 6 || s[0] != 8) return false;  // 8-bit samples only
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height <= 0 || width <= 0 || (nc != 1 && nc != 3) ||
        n < size_t(6 + 3 * nc))
      return false;
    comps.resize(nc);
    hmax = vmax = 1;
    for (int c = 0; c < nc; ++c) {
      Component& k = comps[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return false;
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& k : comps) {
      if (hmax % k.h || vmax % k.v) return false;  // integral ratios only
      k.dw = int((int64_t(width) * k.h + hmax - 1) / hmax);
      k.dh = int((int64_t(height) * k.v + vmax - 1) / vmax);
      k.wb = (k.dw + 7) / 8;
      k.hb = (k.dh + 7) / 8;
      k.stride = mcux * k.h * 8;
      k.rows = mcuy * k.v * 8;
      k.plane.assign(size_t(k.stride) * k.rows, 0);
      if (progressive) {
        k.coef.assign(size_t(k.stride / 8) * (k.rows / 8) * 64, 0);
        std::fill(k.coef_bits, k.coef_bits + 64, -1);
      }
    }
    frame = true;
    return true;
  }

  // ----------------------------------------- progressive (jdphuff.c)
  int16_t* Block(Component& k, int by, int bx) {
    return k.coef.data() + (size_t(by) * (k.stride / 8) + bx) * 64;
  }

  bool DcFirst(BitReader& br, Component& k, int16_t* blk, int al) {
    int s = br.Decode(dc[k.dc_table]);
    if (s < 0 || s > 15) return false;
    if (s) k.pred += Extend(br.Get(s), s);
    blk[0] = int16_t(uint32_t(k.pred) << al);  // LEFT_SHIFT, then JCOEF
    return true;
  }

  bool AcFirst(BitReader& br, const Component& k, int16_t* blk, int ss,
               int se, int al) {
    if (eobrun > 0) {  // a block of the band's run of zero blocks
      --eobrun;
      return true;
    }
    const HuffTable& t = ac[k.ac_table];
    for (int i = ss; i <= se; ++i) {
      int rs = br.Decode(t);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        // jpeg_natural_order's 16 extra entries are all 63
        blk[kNatural[std::min(i, 63)]] =
            int16_t(uint32_t(Extend(br.Get(s), s)) << al);
      } else if (r == 15) {
        i += 15;  // ZRL
      } else {  // EOBr: this block ends the band, 2^r + bits blocks in all
        eobrun = 1 << r;
        if (r) eobrun += int(br.Get(r));
        --eobrun;
        break;
      }
    }
    return true;
  }

  bool AcRefine(BitReader& br, const Component& k, int16_t* blk, int ss,
                int se, int al) {
    const int p1 = 1 << al, m1 = -p1;
    // a correction bit for a coefficient already nonzero
    auto refine = [&](int16_t* c) {
      if (br.Get(1) && (*c & p1) == 0) *c = int16_t(*c + (*c >= 0 ? p1 : m1));
    };
    int i = ss;
    if (eobrun == 0) {
      const HuffTable& t = ac[k.ac_table];
      for (; i <= se; ++i) {
        int rs = br.Decode(t);
        if (rs < 0) return false;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // s != 1 is libjpeg's JWRN_HUFF_BAD_CODE warning: it decodes on
          s = br.Get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += int(br.Get(r));
          break;  // the rest of the band: the EOB run below
        }
        // past the nonzero coefficients (a correction bit each) and r
        // zero ones, to where the new coefficient goes
        do {
          int16_t* c = blk + kNatural[std::min(i, 63)];
          if (*c != 0) {
            refine(c);
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) blk[kNatural[std::min(i, 63)]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0) refine(c);
      }
      --eobrun;
    }
    return true;
  }

  // The scan's MCUs in order (one block each when the scan holds one
  // component, else each component's h x v blocks), with a restart every
  // `restart_interval` MCUs: restart(n) steps over RSTn and resets the
  // entropy decoder's state, block(k, by, bx) decodes block (by, bx) of
  // component k.
  template <class Restart, class Blk>
  bool WalkScan(const std::vector<Component*>& sc, Restart restart,
                Blk block) {
    const int ns = int(sc.size());
    int mcux, mcuy;
    if (ns == 1) {
      mcux = sc[0]->wb;
      mcuy = sc[0]->hb;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int64_t total = int64_t(mcux) * mcuy, left = restart_interval;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (left == 0) {
          if (!restart(next_rst)) return false;
          next_rst = (next_rst + 1) & 7;
          left = restart_interval;
        }
        --left;
      }
      int my = int(m / mcux), mx = int(m % mcux);
      if (ns == 1) {
        if (!block(*sc[0], my, mx)) return false;
      } else {
        for (Component* k : sc)
          for (int by = 0; by < k->v; ++by)
            for (int bx = 0; bx < k->h; ++bx)
              if (!block(*k, my * k->v + by, mx * k->h + bx)) return false;
      }
    }
    return true;
  }

  uint8_t* PlaneBlock(Component& k, int by, int bx) {
    return k.plane.data() + size_t(by) * 8 * k.stride + bx * 8;
  }

  // A progressive scan's header, checked as jdphuff.c's and jdarith.c's
  // start_pass check it (an error there), the quantisers latched and the
  // components' known coefficient bits advanced.
  bool StartProgressiveScan(const std::vector<Component*>& sc, int ss, int se,
                            int ah, int al) {
    if (ss == 0 ? se != 0 : (ss > se || se > 63 || sc.size() != 1))
      return false;
    if ((ah != 0 && al != ah - 1) || al > 13) return false;
    for (Component* k : sc) {
      if (!arith) {  // a Huffman scan needs the tables its kind reads
        if (ss == 0 && ah == 0 && !dc[k->dc_table].present) return false;
        if (ss != 0 && !ac[k->ac_table].present) return false;
      }
      if (!k->latched) {  // latch_quant_tables: a later DQT does not apply
        if (!has_quant[k->tq]) return false;
        std::memcpy(k->qt, quant[k->tq], sizeof(k->qt));
        k->latched = true;
      }
      // libjpeg warns (JWRN_BOGUS_PROGRESSION) and decodes on; refused
      // here, as the pixels would then hang on its block smoothing
      if (ss != 0 && k->coef_bits[0] < 0) return false;
      for (int i = ss; i <= se; ++i) {
        if (ah != std::max(k->coef_bits[i], 0)) return false;
        k->coef_bits[i] = al;
      }
    }
    return true;
  }

  bool ReadProgressiveScan(const std::vector<Component*>& sc, int ss, int se,
                           int ah, int al) {
    eobrun = 0;
    BitReader br{buf + pos, buf + len};
    auto restart = [&](int n) {
      if (br.Overran() || !br.Restart(n)) return false;
      for (Component* k : sc) k->pred = 0;
      eobrun = 0;
      return true;
    };
    auto block = [&](Component& k, int by, int bx) {
      int16_t* b = Block(k, by, bx);
      if (ss == 0) {
        if (ah == 0) return DcFirst(br, k, b, al);
        if (br.Get(1)) b[0] = int16_t(b[0] | (1 << al));  // DC refine
        return true;
      }
      return ah == 0 ? AcFirst(br, k, b, ss, se, al)
                     : AcRefine(br, k, b, ss, se, al);
    };
    if (!WalkScan(sc, restart, block) || br.Overran()) return false;
    pos = size_t(br.p - buf);
    return true;
  }

  // After EOI: dequantise and inverse-transform every block of each
  // component, as jdcoefct.c decompress_data does (width_in_blocks x
  // height_in_blocks; the MCU padding is never read). Its block smoothing
  // (jdcoefct.c decompress_smooth_data) runs only while smoothing_ok finds
  // a component whose DC or first AC coefficients still lack bits; in a
  // complete file every coefficient ends at 0 unknown bits and it is off.
  // It is not ported: a file that would take it is refused instead.
  bool FinishProgressive() {
    if (!eoi) return false;  // truncated: libjpeg would smooth what is left
    for (Component& k : comps) {
      for (int i = 0; i < 10; ++i)  // SAVED_COEFS: 6, or 10 since turbo 2.1
        if (k.coef_bits[i] != 0) return false;
      for (int by = 0; by < k.hb; ++by)
        for (int bx = 0; bx < k.wb; ++bx)
          IdctIslow(Block(k, by, bx), k.qt,
                    k.plane.data() + size_t(by) * 8 * k.stride + bx * 8,
                    size_t(k.stride));
    }
    return true;
  }

  bool DecodeBlock(BitReader& br, Component& k, uint8_t* out) {
    int16_t coef[64] = {};
    int s = br.Decode(dc[k.dc_table]);
    if (s < 0 || s > 15) return false;
    if (s) k.pred += Extend(br.Get(s), s);
    coef[0] = int16_t(k.pred);
    const HuffTable& t = ac[k.ac_table];
    for (int i = 1; i < 64; ++i) {
      int rs = br.Decode(t);
      if (rs < 0) return false;
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        i = std::min(i + r, 63);
        coef[kNatural[i]] = int16_t(Extend(br.Get(sz), sz));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    IdctIslow(coef, k.qt, out, size_t(k.stride));
    return true;
  }

  // ------------------------------------------ arithmetic scans (jdarith.c)
  // A DC difference (figures F.19-F.24), its bins chosen by the component's
  // context, which the difference's magnitude category then sets against
  // the table's L and U; the prediction is kept modulo 2^16, as libjpeg
  // keeps it, and stored shifted by `al`.
  bool ArithDc(ArithReader& ar, Component& k, int16_t* blk, int al) {
    const int tbl = k.dc_table;
    uint8_t* st = dc_stats[tbl] + k.dc_context;
    if (ar.Decode(st) == 0) {
      k.dc_context = 0;
    } else {
      const int sign = ar.Decode(st + 1);
      st += 2 + sign;
      int m = ar.Decode(st);
      if (m) {
        st = dc_stats[tbl] + 20;
        while (ar.Decode(st)) {
          if ((m <<= 1) == 0x8000) return false;  // magnitude overflow
          ++st;
        }
      }
      if (m < (1 << arith_dc_l[tbl]) >> 1)
        k.dc_context = 0;
      else if (m > (1 << arith_dc_u[tbl]) >> 1)
        k.dc_context = 12 + sign * 4;
      else
        k.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.Decode(st)) v |= m;
      v += 1;
      k.pred = (k.pred + (sign ? -v : v)) & 0xFFFF;
    }
    blk[0] = int16_t(uint32_t(k.pred) << al);
    return true;
  }

  // Coefficients ss..se of a block (figure F.20): an end-of-band decision
  // before each run of zeros, the sign at the fixed bin, the magnitude
  // category's bins chosen by the position against the table's Kx.
  bool ArithAcFirst(ArithReader& ar, const Component& k, int16_t* blk, int ss,
                    int se, int al) {
    const int tbl = k.ac_table;
    for (int i = ss; i <= se; ++i) {
      uint8_t* st = ac_stats[tbl] + 3 * (i - 1);
      if (ar.Decode(st)) break;  // end of band
      while (ar.Decode(st + 1) == 0) {
        st += 3;
        if (++i > se) return false;  // spectral overflow
      }
      const int sign = ar.Decode(&fixed_bin);
      st += 2;
      int m = ar.Decode(st);
      if (m && ar.Decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (i <= arith_ac_k[tbl] ? 189 : 217);
        while (ar.Decode(st)) {
          if ((m <<= 1) == 0x8000) return false;  // magnitude overflow
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.Decode(st)) v |= m;
      v += 1;
      blk[kNatural[i]] = int16_t(uint32_t(sign ? -v : v) << al);
    }
    return true;
  }

  // A refinement of coefficients ss..se: no end-of-band decision up to the
  // last coefficient an earlier scan made nonzero; a correction bit for
  // each nonzero one, a newly nonzero one at +-2^al.
  bool ArithAcRefine(ArithReader& ar, const Component& k, int16_t* blk,
                     int ss, int se, int al) {
    const int tbl = k.ac_table;
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;
    while (kex > 0 && blk[kNatural[kex]] == 0) --kex;
    for (int i = ss; i <= se; ++i) {
      uint8_t* st = ac_stats[tbl] + 3 * (i - 1);
      if (i > kex && ar.Decode(st)) break;  // end of band
      for (;;) {
        int16_t* c = blk + kNatural[i];
        if (*c) {
          if (ar.Decode(st + 2)) *c = int16_t(*c + (*c < 0 ? m1 : p1));
          break;
        }
        if (ar.Decode(st + 1)) {
          *c = int16_t(ar.Decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++i > se) return false;  // spectral overflow
      }
    }
    return true;
  }

  // One arithmetic-coded scan, sequential (each block whole, then its
  // IDCT) or progressive (into the coefficient buffer). The statistics of
  // the tables the scan reads start at zero, and again at each restart.
  bool ReadArithScan(const std::vector<Component*>& sc, int ss, int se,
                     int ah, int al) {
    const bool dc_bins = !progressive || (ss == 0 && ah == 0);
    const bool ac_bins = !progressive || ss != 0;
    auto reset = [&] {
      for (Component* k : sc) {
        if (dc_bins) {
          std::memset(dc_stats[k->dc_table], 0, sizeof(dc_stats[0]));
          k->pred = 0;
          k->dc_context = 0;
        }
        if (ac_bins) std::memset(ac_stats[k->ac_table], 0, sizeof(ac_stats[0]));
      }
    };
    reset();
    ArithReader ar{buf + pos, buf + len};
    auto restart = [&](int n) {
      if (!ar.Restart(n)) return false;
      reset();
      return true;
    };
    auto block = [&](Component& k, int by, int bx) {
      if (!progressive) {
        int16_t coef[64] = {};
        if (!ArithDc(ar, k, coef, 0) || !ArithAcFirst(ar, k, coef, 1, 63, 0))
          return false;
        IdctIslow(coef, k.qt, PlaneBlock(k, by, bx), size_t(k.stride));
        return true;
      }
      int16_t* b = Block(k, by, bx);
      if (ss == 0) {
        if (ah == 0) return ArithDc(ar, k, b, al);
        if (ar.Decode(&fixed_bin)) b[0] = int16_t(b[0] | (1 << al));
        return true;
      }
      return ah == 0 ? ArithAcFirst(ar, k, b, ss, se, al)
                     : ArithAcRefine(ar, k, b, ss, se, al);
    };
    if (!WalkScan(sc, restart, block)) return false;
    pos = size_t(ar.p - buf);
    return true;
  }

  bool ReadScan(const uint8_t* s, size_t n) {
    if (!frame || n < 1) return false;
    int ns = s[0];
    if (ns < 1 || ns > 4 || n < size_t(4 + 2 * ns)) return false;
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Component* k = nullptr;
      for (Component& c : comps)
        if (c.id == id) k = &c;
      if (!k) return false;
      k->dc_table = s[2 + 2 * i] >> 4;
      k->ac_table = s[2 + 2 * i] & 15;
      // Huffman tables 0-3 (jdhuff.c); arithmetic ones 0-15 (jdarith.c)
      if (!arith && (k->dc_table > 3 || k->ac_table > 3)) return false;
      if (!progressive) {
        if (!has_quant[k->tq]) return false;
        if (!arith &&
            (!dc[k->dc_table].present || !ac[k->ac_table].present))
          return false;
        std::memcpy(k->qt, quant[k->tq], sizeof(k->qt));
      }
      k->pred = 0;
      sc.push_back(k);
    }
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    const int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (progressive && !StartProgressiveScan(sc, ss, se, ah, al)) return false;
    if (arith) return ReadArithScan(sc, ss, se, ah, al);
    if (progressive) return ReadProgressiveScan(sc, ss, se, ah, al);
    BitReader br{buf + pos, buf + len};
    auto restart = [&](int m) {
      if (!br.Restart(m)) return false;
      for (Component* k : sc) k->pred = 0;
      return true;
    };
    auto block = [&](Component& k, int by, int bx) {
      return DecodeBlock(br, k, PlaneBlock(k, by, bx));
    };
    if (!WalkScan(sc, restart, block)) return false;
    pos = size_t(br.p - buf);
    return true;
  }

  // Position `pos` on the next marker's 0xFF (skipping entropy bytes).
  void SkipToMarker() {
    while (pos + 1 < len &&
           !(buf[pos] == 0xFF && buf[pos + 1] != 0x00 && buf[pos + 1] != 0xFF &&
             !(buf[pos + 1] >= 0xD0 && buf[pos + 1] <= 0xD7)))
      ++pos;
  }

  bool Parse() {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return false;
    pos = 2;
    bool scanned = false;
    while (true) {
      SkipToMarker();
      if (pos + 1 >= len) return scanned;  // truncated after the scans
      int m = buf[pos + 1];
      pos += 2;
      if (m == 0xD9) {
        eoi = true;
        return scanned;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      const uint8_t* s;
      size_t n;
      if (!Segment(&s, &n)) return false;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:  // progressive, Huffman
        case 0xC9:  // sequential, arithmetic
        case 0xCA:  // progressive, arithmetic
          progressive = m == 0xC2 || m == 0xCA;
          arith = m == 0xC9 || m == 0xCA;
          if (!ReadSOF(s, n)) return false;
          break;
        case 0xCC:
          if (!ReadDAC(s, n)) return false;
          break;
        case 0xC4:
          if (!ReadDHT(s, n)) return false;
          break;
        case 0xDB:
          if (!ReadDQT(s, n)) return false;
          break;
        case 0xDD:
          if (n < 2) return false;
          restart_interval = (s[0] << 8) | s[1];
          break;
        case 0xDA:
          if (!ReadScan(s, n)) return false;
          scanned = true;
          break;
        case 0xE0:
          if (n >= 14 && !std::memcmp(s, "JFIF", 5)) jfif = true;
          break;
        case 0xEE:
          if (n >= 12 && !std::memcmp(s, "Adobe", 5)) {
            adobe = true;
            adobe_transform = s[11];
          }
          break;
        default:
          // lossless (SOF3, SOF11) and hierarchical (SOF5-7, SOF13-15)
          // frames and JPG, which libjpeg refuses, and DNL: refused
          if ((m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xCC) ||
              m == 0xDC)
            return false;
          break;
      }
    }
  }

  // jdsample.c: one component brought to full resolution, `stride` = the
  // upsampled row length (rows cover the image height, plus one row at most).
  void Upsample(const Component& k, std::vector<uint8_t>* out, int* ostride) {
    const int hx = hmax / k.h, vy = vmax / k.v;
    const int ow = k.dw * hx, oh = k.dh * vy;
    *ostride = ow;
    out->resize(size_t(ow) * oh);
    const uint8_t* pl = k.plane.data();
    auto row = [&](int r) {
      r = std::min(std::max(r, 0), k.dh - 1);  // the context rows' edges
      return pl + size_t(r) * k.stride;
    };
    uint8_t* o = out->data();
    const int dw = k.dw;
    if (hx == 2 && vy == 2 && dw > 2) {  // h2v2_fancy_upsample
      for (int r = 0; r < k.dh; ++r) {
        for (int v = 0; v < 2; ++v) {
          const uint8_t* in0 = row(r);
          const uint8_t* in1 = row(v == 0 ? r - 1 : r + 1);
          uint8_t* op = o + size_t(2 * r + v) * ow;
          int this_s = in0[0] * 3 + in1[0];
          int next_s = in0[1] * 3 + in1[1];
          op[0] = uint8_t((this_s * 4 + 8) >> 4);
          op[1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
          int last_s = this_s;
          this_s = next_s;
          for (int c = 2; c < dw; ++c) {
            next_s = in0[c] * 3 + in1[c];
            op[2 * c - 2] = uint8_t((this_s * 3 + last_s + 8) >> 4);
            op[2 * c - 1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
            last_s = this_s;
            this_s = next_s;
          }
          op[2 * dw - 2] = uint8_t((this_s * 3 + last_s + 8) >> 4);
          op[2 * dw - 1] = uint8_t((this_s * 4 + 7) >> 4);
        }
      }
    } else if (hx == 2 && vy == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int r = 0; r < k.dh; ++r) {
        const uint8_t* in = row(r);
        uint8_t* op = o + size_t(r) * ow;
        op[0] = in[0];
        op[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
        for (int c = 1; c < dw - 1; ++c) {
          int v = in[c] * 3;
          op[2 * c] = uint8_t((v + in[c - 1] + 1) >> 2);
          op[2 * c + 1] = uint8_t((v + in[c + 1] + 2) >> 2);
        }
        op[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        op[2 * dw - 1] = in[dw - 1];
      }
    } else if (hx == 1 && vy == 2) {  // h1v2_fancy_upsample
      for (int r = 0; r < k.dh; ++r) {
        for (int v = 0; v < 2; ++v) {
          const uint8_t* in0 = row(r);
          const uint8_t* in1 = row(v == 0 ? r - 1 : r + 1);
          int bias = v == 0 ? 1 : 2;
          uint8_t* op = o + size_t(2 * r + v) * ow;
          for (int c = 0; c < dw; ++c)
            op[c] = uint8_t((in0[c] * 3 + in1[c] + bias) >> 2);
        }
      }
    } else {  // full size, or box replication (int_upsample, h2v*_upsample)
      for (int y = 0; y < oh; ++y) {
        const uint8_t* in = pl + size_t(y / vy) * k.stride;
        uint8_t* op = o + size_t(y) * ow;
        for (int x = 0; x < ow; ++x) op[x] = in[x / hx];
      }
    }
  }

  bool Run(std::vector<uint8_t>* out, int* h, int* w) {
    if (!Parse() || !frame) return false;
    if (progressive && !FinishProgressive()) return false;
    *h = height;
    *w = width;
    out->resize(size_t(height) * width * 3);
    uint8_t* o = out->data();
    if (comps.size() == 1) {
      std::vector<uint8_t> up;
      int st;
      Upsample(comps[0], &up, &st);
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
          uint8_t v = up[size_t(y) * st + x];
          uint8_t* p = o + (size_t(y) * width + x) * 3;
          p[0] = p[1] = p[2] = v;
        }
      return true;
    }
    std::vector<uint8_t> up[3];
    int st[3];
    for (int c = 0; c < 3; ++c) Upsample(comps[c], &up[c], &st[c]);
    bool ycc;
    if (jfif) {
      ycc = true;
    } else if (adobe) {
      ycc = adobe_transform != 0;
    } else {
      ycc = !(comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66);
    }
    const ColorTables& t = Tables();
    for (int y = 0; y < height; ++y) {
      const uint8_t* yr = up[0].data() + size_t(y) * st[0];
      const uint8_t* br = up[1].data() + size_t(y) * st[1];
      const uint8_t* rr = up[2].data() + size_t(y) * st[2];
      uint8_t* p = o + size_t(y) * width * 3;
      for (int x = 0; x < width; ++x, p += 3) {
        int yy = yr[x], cb = br[x], cr = rr[x];
        if (!ycc) {
          p[0] = uint8_t(yy);
          p[1] = uint8_t(cb);
          p[2] = uint8_t(cr);
          continue;
        }
        p[0] = Clamp255(yy + t.cr_r[cr]);
        p[1] = Clamp255(yy + int((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits));
        p[2] = Clamp255(yy + t.cb_b[cb]);
      }
    }
    return true;
  }
};

// Decode JPEG bytes to HWC u8 RGB. Returns false on failure (not a JPEG
// the codec takes).
bool Decode(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
            int* height, int* width) {
  if (len < 2 || buf[0] != 0xFF || buf[1] != 0xD8) return false;
  Decoder d(buf, len);
  return d.Run(out, height, width);
}

// ------------------------------------------------------------- encoding
// The tables of the JPEG standard's Annex K, as libjpeg's jcparam.c /
// jstdhuff.c hold them (quantisers in natural order).
constexpr uint16_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint16_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
constexpr uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                     1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                     5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                       7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  EncTable(const uint8_t* b, const uint8_t* v) : bits(b), vals(v) {
    nvals = 0;
    for (int l = 1; l <= 16; ++l) nvals += b[l];
    int k = 0, c = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < b[l]; ++i, ++k, ++c) {
        code[v[k]] = uint16_t(c);
        size[v[k]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;
  int bits = 0;
  void Put(uint32_t v, int n) {
    if (!n) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    bits += n;
    while (bits >= 8) {
      uint8_t b = uint8_t(acc >> (bits - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
      bits -= 8;
    }
  }
  void Flush() {
    if (bits) Put(0x7F, 7);  // pad with ones to a byte boundary
    bits = 0;
    acc = 0;
  }
};

inline int NBits(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}

void EncodeBlock(BitWriter& bw, const int* qc, int* pred, const EncTable& dct,
                 const EncTable& act) {
  int diff = qc[0] - *pred;
  *pred = qc[0];
  int n = NBits(diff);
  bw.Put(dct.code[n], dct.size[n]);
  if (n) bw.Put(uint32_t(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = qc[kNatural[k]];
    if (!v) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.Put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    int s = NBits(v);
    int rs = (run << 4) | s;
    bw.Put(act.code[rs], act.size[rs]);
    bw.Put(uint32_t(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run) bw.Put(act.code[0], act.size[0]);
}

void Marker(std::vector<uint8_t>* o, uint8_t m) {
  o->push_back(0xFF);
  o->push_back(m);
}
void Word(std::vector<uint8_t>* o, int v) {
  o->push_back(uint8_t(v >> 8));
  o->push_back(uint8_t(v & 0xFF));
}

// Encode HWC u8 (channels 1 or 3) as baseline JPEG at `quality`, as
// libjpeg with jpeg_set_defaults, jpeg_set_quality(quality, TRUE) and
// nothing else set: JFIF 1.01 with a 1:1 density, 4:2:0 for colour.
bool Encode(const uint8_t* px, int height, int width, int channels,
            int quality, std::vector<uint8_t>* out) {
  if (height <= 0 || width <= 0 || height > 65535 || width > 65535 ||
      (channels != 1 && channels != 3))
    return false;
  quality = std::min(100, std::max(1, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      int64_t v = (int64_t((t ? kStdChroma : kStdLuma)[i]) * scale + 50) / 100;
      qt[t][i] = uint16_t(std::min<int64_t>(255, std::max<int64_t>(1, v)));
    }
  const int nc = channels;
  const int hmax = nc == 3 ? 2 : 1, vmax = hmax;
  // full-resolution planes, edge-replicated to the MCU grid
  const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  const int fw = mcux * 8 * hmax, fh = mcuy * 8 * vmax;
  std::vector<uint8_t> full[3];
  for (int c = 0; c < nc; ++c) full[c].resize(size_t(fw) * fh);
  const ColorTables& t = Tables();
  for (int y = 0; y < fh; ++y) {
    const uint8_t* row = px + size_t(std::min(y, height - 1)) * width * nc;
    for (int x = 0; x < fw; ++x) {
      const uint8_t* p = row + size_t(std::min(x, width - 1)) * nc;
      size_t at = size_t(y) * fw + x;
      if (nc == 1) {
        full[0][at] = p[0];
        continue;
      }
      int r = p[0], g = p[1], b = p[2];
      full[0][at] = uint8_t((t.r_y[r] + t.g_y[g] + t.b_y[b]) >> kScaleBits);
      full[1][at] = uint8_t((t.r_cb[r] + t.g_cb[g] + t.b_cb[b]) >> kScaleBits);
      full[2][at] = uint8_t((t.b_cb[r] + t.g_cr[g] + t.b_cr[b]) >> kScaleBits);
    }
  }
  // h2v2_downsample of the chroma planes (the alternating 1, 2 bias);
  // rows past the image's own are copies of its last, as libjpeg pads
  std::vector<uint8_t> sub[3];
  const int cw = fw / 2, ch = fh / 2;
  for (int c = 1; c < nc; ++c) {
    sub[c].resize(size_t(cw) * ch);
    for (int y = 0; y < ch; ++y) {
      const int real = (height + 1) / 2;
      if (y >= real) {
        std::memcpy(&sub[c][size_t(y) * cw], &sub[c][size_t(real - 1) * cw],
                    cw);
        continue;
      }
      const uint8_t* r0 = full[c].data() + size_t(2 * y) * fw;
      const uint8_t* r1 = r0 + fw;
      int bias = 1;
      for (int x = 0; x < cw; ++x) {
        sub[c][size_t(y) * cw + x] = uint8_t(
            (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >>
            2);
        bias ^= 3;
      }
    }
  }
  // headers
  out->clear();
  Marker(out, 0xD8);
  Marker(out, 0xE0);
  Word(out, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out->insert(out->end(), jfif, jfif + 14);
  for (int q = 0; q < (nc == 3 ? 2 : 1); ++q) {
    Marker(out, 0xDB);
    Word(out, 67);
    out->push_back(uint8_t(q));
    for (int k = 0; k < 64; ++k) out->push_back(uint8_t(qt[q][kNatural[k]]));
  }
  Marker(out, 0xC0);
  Word(out, 8 + 3 * nc);
  out->push_back(8);
  Word(out, height);
  Word(out, width);
  out->push_back(uint8_t(nc));
  for (int c = 0; c < nc; ++c) {
    out->push_back(uint8_t(c + 1));
    out->push_back(c == 0 ? uint8_t((hmax << 4) | vmax) : 0x11);
    out->push_back(c == 0 ? 0 : 1);
  }
  const EncTable dct[2] = {{kDcLumaBits, kDcVals}, {kDcChromaBits, kDcVals}};
  const EncTable act[2] = {{kAcLumaBits, kAcLumaVals},
                           {kAcChromaBits, kAcChromaVals}};
  for (int q = 0; q < (nc == 3 ? 2 : 1); ++q) {
    for (int cls = 0; cls < 2; ++cls) {
      const EncTable& e = cls ? act[q] : dct[q];
      Marker(out, 0xC4);
      Word(out, 2 + 1 + 16 + e.nvals);
      out->push_back(uint8_t((cls << 4) | q));
      for (int l = 1; l <= 16; ++l) out->push_back(e.bits[l]);
      out->insert(out->end(), e.vals, e.vals + e.nvals);
    }
  }
  Marker(out, 0xDA);
  Word(out, 6 + 2 * nc);
  out->push_back(uint8_t(nc));
  for (int c = 0; c < nc; ++c) {
    out->push_back(uint8_t(c + 1));
    out->push_back(c == 0 ? 0x00 : 0x11);
  }
  out->push_back(0);
  out->push_back(63);
  out->push_back(0);
  // entropy-coded data; libjpeg's dummy blocks past a component's width
  // and height in blocks carry the previous block's DC and no AC
  BitWriter bw{out};
  int pred[3] = {0, 0, 0};
  int wb[3], hb[3];
  for (int c = 0; c < nc; ++c) {
    int cwid = c == 0 ? width : (width + 1) / 2;
    int chei = c == 0 ? height : (height + 1) / 2;
    wb[c] = (cwid + 7) / 8;
    hb[c] = (chei + 7) / 8;
  }
  int blk[64], qc[64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int c = 0; c < nc; ++c) {
        const int hs = c == 0 ? hmax : 1, vs = c == 0 ? vmax : 1;
        const uint8_t* plane = c == 0 ? full[0].data() : sub[c].data();
        const int stride = c == 0 ? fw : cw;
        const int qi = c == 0 ? 0 : 1;
        for (int by = 0; by < vs; ++by) {
          for (int bx = 0; bx < hs; ++bx) {
            int gy = my * vs + by, gx = mx * hs + bx;
            if (gy >= hb[c] || gx >= wb[c]) {
              std::memset(qc, 0, sizeof(qc));
              qc[0] = pred[c];
            } else {
              for (int y = 0; y < 8; ++y)
                for (int x = 0; x < 8; ++x)
                  blk[y * 8 + x] =
                      int(plane[size_t(gy * 8 + y) * stride + gx * 8 + x]) -
                      128;
              FdctIslow(blk);
              for (int i = 0; i < 64; ++i) {
                int d = qt[qi][i] << 3;
                int v = blk[i];
                qc[i] = v < 0 ? -((-v + (d >> 1)) / d) : (v + (d >> 1)) / d;
              }
            }
            EncodeBlock(bw, qc, &pred[c], dct[qi], act[qi]);
          }
        }
      }
    }
  }
  bw.Flush();
  Marker(out, 0xD9);
  return true;
}

}  // namespace jpeg

namespace {

constexpr uint32_t kRecordMagic = 0x54524543;  // 'CREC'

struct RecordHeader {
  uint32_t magic;
  uint32_t crc;
  uint64_t length;
} __attribute__((packed));

struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
} __attribute__((packed));

// Bilinear resize HWC u8 -> HWC u8 in 16.16 fixed point, the x-axis taps
// and weights computed once per image.
void ResizeBilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw) {
  constexpr int kShift = 16;
  constexpr int64_t kOne = int64_t(1) << kShift;
  const int64_t ry = dh > 1 ? (int64_t(sh - 1) << kShift) / (dh - 1) : 0;
  const int64_t rx = dw > 1 ? (int64_t(sw - 1) << kShift) / (dw - 1) : 0;

  std::vector<int> x0s(dw), x1s(dw);
  std::vector<int64_t> wxs(dw);
  for (int x = 0; x < dw; ++x) {
    int64_t fx = x * rx;
    int x0 = int(fx >> kShift);
    x0s[x] = x0;
    x1s[x] = std::min(x0 + 1, sw - 1);
    wxs[x] = fx & (kOne - 1);
  }
  for (int y = 0; y < dh; ++y) {
    int64_t fy = y * ry;
    int y0 = int(fy >> kShift), y1 = std::min(y0 + 1, sh - 1);
    int64_t wy = fy & (kOne - 1);
    const uint8_t* r0 = src + size_t(y0) * sw * 3;
    const uint8_t* r1 = src + size_t(y1) * sw * 3;
    uint8_t* out = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p00 = r0 + x0s[x] * 3;
      const uint8_t* p01 = r0 + x1s[x] * 3;
      const uint8_t* p10 = r1 + x0s[x] * 3;
      const uint8_t* p11 = r1 + x1s[x] * 3;
      int64_t wx = wxs[x];
      for (int c = 0; c < 3; ++c) {
        // rows in x (<<16), then between the rows in y (<<32)
        int64_t top = p00[c] * (kOne - wx) + p01[c] * wx;
        int64_t bot = p10[c] * (kOne - wx) + p11[c] * wx;
        int64_t v = top * (kOne - wy) + bot * wy;
        out[x * 3 + c] = uint8_t((v + (int64_t(1) << 31)) >> 32);
      }
    }
  }
}

struct PipelineConfig {
  int batch, channels, height, width, label_width;
  int rand_crop, rand_mirror, resize_short;
  float mean[3];
  int has_mean;
  float scale;
  // random resize scale in [min_rscale, max_rscale]; per-dimension size
  // clamps (0 = off); out = (px - mean) * c + i with c ~ U[1-max_contrast,
  // 1+max_contrast], i ~ U[-max_illum, max_illum]; a fixed mirror
  float min_rscale, max_rscale;
  float min_img, max_img;
  float max_contrast, max_illum;
  int mirror;
  int shuffle;
  uint32_t seed;
  int num_threads, prefetch;
  int round_batch;
  int nhwc;    // emit [B,H,W,C] batches instead of [B,C,H,W]
  int out_u8;  // emit raw uint8 pixels (mean/scale left to the device)
};

struct Batch {
  std::vector<float> data;     // when !out_u8
  std::vector<uint8_t> data8;  // when out_u8
  std::vector<float> labels;
  int pad;
};

class ImagePipeline {
 public:
  ImagePipeline(const char* path, const int64_t* offsets, int64_t n,
                const PipelineConfig& cfg)
      : cfg_(cfg), offsets_(offsets, offsets + n) {
    const char* skip = getenv("MXTPU_NATIVE_SKIP_DECODE");
    skip_decode_ = skip && skip[0] == '1';
    const char* skipw = getenv("MXTPU_NATIVE_SKIP_WORK");
    skip_work_ = skipw && skipw[0] == '1';
    fd_ = open(path, O_RDONLY);
    ok_ = fd_ >= 0;
    epoch_ = 0;
    StartEpoch();
  }

  ~ImagePipeline() {
    Shutdown();
    if (fd_ >= 0) close(fd_);
  }

  bool ok() const { return ok_; }

  // Pops the next in-order batch; returns 1 at epoch end, 0 on success,
  // negative on error. ``data_out`` is float* or uint8* per cfg.out_u8.
  int Next(void* data_out, float* label_out, int* pad_out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (deliver_next_ >= tickets_total_) return 1;
    cv_ready_.wait(lk, [&] { return ready_.count(deliver_next_) || failed_; });
    if (failed_) return -1;
    Batch b = std::move(ready_[deliver_next_]);
    ready_.erase(deliver_next_);
    ++deliver_next_;
    cv_space_.notify_all();
    lk.unlock();
    if (cfg_.out_u8)
      std::memcpy(data_out, b.data8.data(), b.data8.size());
    else
      std::memcpy(data_out, b.data.data(), b.data.size() * sizeof(float));
    std::memcpy(label_out, b.labels.data(), b.labels.size() * sizeof(float));
    *pad_out = b.pad;
    return 0;
  }

  void Reset() {
    Shutdown();
    ++epoch_;
    StartEpoch();
  }

  int64_t BatchesPerEpoch() const { return tickets_total_; }

 private:
  void StartEpoch() {
    order_.resize(offsets_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    if (cfg_.shuffle) {
      std::mt19937 rng(cfg_.seed + epoch_);
      std::shuffle(order_.begin(), order_.end(), rng);
    }
    int64_t n = order_.size();
    tickets_total_ =
        cfg_.round_batch ? (n + cfg_.batch - 1) / cfg_.batch : n / cfg_.batch;
    ticket_counter_ = 0;
    deliver_next_ = 0;
    failed_ = false;
    stop_ = false;
    ready_.clear();
    int nthreads = std::max(1, cfg_.num_threads);
    for (int i = 0; i < nthreads; ++i)
      workers_.emplace_back(&ImagePipeline::WorkerLoop, this, i);
  }

  void Shutdown() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
      cv_space_.notify_all();
      cv_ready_.notify_all();
    }
    for (auto& t : workers_) t.join();
    workers_.clear();
  }

  void WorkerLoop(int wid) {
    // each worker's stream; with random augmentation and several workers
    // the batch a stream serves depends on the ticket race
    std::mt19937 rng(cfg_.seed * 9973 + epoch_ * 131 + wid);
    while (true) {
      int64_t ticket = ticket_counter_.fetch_add(1);
      if (ticket >= tickets_total_) return;
      // bounded prefetch: don't run ahead of the consumer
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [&] {
          return stop_ || ticket < deliver_next_ + cfg_.prefetch;
        });
        if (stop_) return;
      }
      Batch b;
      if (!ProduceBatch(ticket, &rng, &b)) {
        std::lock_guard<std::mutex> lk(mu_);
        failed_ = true;
        cv_ready_.notify_all();
        return;
      }
      std::lock_guard<std::mutex> lk(mu_);
      ready_.emplace(ticket, std::move(b));
      cv_ready_.notify_all();
    }
  }

  bool ReadRecord(int64_t offset, std::vector<uint8_t>* payload) {
    RecordHeader hdr;
    if (pread(fd_, &hdr, sizeof(hdr), offset) != sizeof(hdr)) return false;
    if (hdr.magic != kRecordMagic) return false;
    payload->resize(hdr.length);
    ssize_t got = pread(fd_, payload->data(), hdr.length, offset + sizeof(hdr));
    if (got != ssize_t(hdr.length)) return false;
    uint32_t crc = crc32(0, payload->data(), hdr.length);
    return crc == hdr.crc;
  }

  bool ProduceBatch(int64_t ticket, std::mt19937* rng, Batch* out) {
    const int B = cfg_.batch, C = cfg_.channels, H = cfg_.height,
              W = cfg_.width;
    if (cfg_.out_u8)
      out->data8.assign(size_t(B) * C * H * W, 0);
    else
      out->data.assign(size_t(B) * C * H * W, 0.f);
    out->labels.assign(size_t(B) * cfg_.label_width, 0.f);
    int64_t n = order_.size();
    int64_t start = ticket * B;
    out->pad = int(std::max<int64_t>(0, start + B - n));
    if (skip_work_) return true;  // MXTPU_NATIVE_SKIP_WORK=1: zeroed
    // batches, measuring only the serial path (ticketing and the ordered
    // delivery's copy in Next())
    std::vector<uint8_t> payload, pixels, resized;
    for (int i = 0; i < B; ++i) {
      int64_t idx = order_[(start + i) % n];
      if (!ReadRecord(offsets_[idx], &payload)) return false;
      if (payload.size() < sizeof(IRHeader)) return false;
      IRHeader ir;
      std::memcpy(&ir, payload.data(), sizeof(ir));
      const uint8_t* img = payload.data() + sizeof(ir);
      size_t img_len = payload.size() - sizeof(ir);
      float* label_dst = out->labels.data() + size_t(i) * cfg_.label_width;
      if (ir.flag > 0) {
        size_t lbytes = size_t(ir.flag) * sizeof(float);
        if (img_len < lbytes) return false;
        std::memcpy(label_dst, img,
                    sizeof(float) * std::min<int>(ir.flag, cfg_.label_width));
        img += lbytes;
        img_len -= lbytes;
      } else {
        label_dst[0] = ir.label;
      }
      int h, w;
      if (skip_decode_) {
        // MXTPU_NATIVE_SKIP_DECODE=1: a constant fill of a fixed geometry
        // in place of the decode, every other stage live, to measure the
        // pipeline's cost without the decode
        h = w = std::max({256, cfg_.height, cfg_.width});
        pixels.assign(size_t(h) * w * 3, img_len ? img[0] : 0);
      } else if (!jpeg::Decode(img, img_len, &pixels, &h, &w)) {
        return false;
      }
      const uint8_t* hwc = pixels.data();
      // resize so the short side is resize_short (or to fit the crop),
      // jittered by the random scale factor and clamped to the img-size
      // bounds; the result stays crop-feasible (>= data_shape)
      float rscale = 1.f;
      if (cfg_.min_rscale != 1.f || cfg_.max_rscale != 1.f) {
        float u = float((*rng)()) * (1.f / 4294967296.f);
        rscale = cfg_.min_rscale + u * (cfg_.max_rscale - cfg_.min_rscale);
      }
      int target_short = cfg_.resize_short;
      if (h < H || w < W || target_short > 0 || rscale != 1.f ||
          cfg_.min_img > 0.f || cfg_.max_img > 0.f) {
        int short_side = std::min(h, w);
        float s = target_short > 0 ? float(target_short) / short_side : 1.f;
        s *= rscale;
        float fnh = h * s, fnw = w * s;
        if (cfg_.min_img > 0.f) {
          fnh = std::max(fnh, cfg_.min_img);
          fnw = std::max(fnw, cfg_.min_img);
        }
        if (cfg_.max_img > 0.f) {
          fnh = std::min(fnh, cfg_.max_img);
          fnw = std::min(fnw, cfg_.max_img);
        }
        int nh = std::max(H, int(fnh + 0.5f));
        int nw = std::max(W, int(fnw + 0.5f));
        if (nh != h || nw != w) {  // an identity resize is a no-op
          resized.resize(size_t(nh) * nw * 3);
          ResizeBilinear(pixels.data(), h, w, resized.data(), nh, nw);
          hwc = resized.data();
          h = nh;
          w = nw;
        }
      }
      int top, left;
      if (cfg_.rand_crop) {
        top = int((*rng)() % uint32_t(h - H + 1));
        left = int((*rng)() % uint32_t(w - W + 1));
      } else {
        top = (h - H) / 2;
        left = (w - W) / 2;
      }
      bool mirror = cfg_.rand_mirror && ((*rng)() & 1u);
      if (cfg_.mirror) mirror = true;
      float con = 1.f, ill = 0.f;
      if (!cfg_.out_u8 && (cfg_.max_contrast > 0.f || cfg_.max_illum > 0.f)) {
        float u1 = float((*rng)()) * (1.f / 4294967296.f);
        float u2 = float((*rng)()) * (1.f / 4294967296.f);
        con = 1.f + (u1 * 2.f - 1.f) * cfg_.max_contrast;
        ill = (u2 * 2.f - 1.f) * cfg_.max_illum;
      }
      const bool nhwc = cfg_.nhwc != 0;
      float* dst = cfg_.out_u8 ? nullptr
                               : out->data.data() + size_t(i) * C * H * W;
      uint8_t* dst8 = cfg_.out_u8
                          ? out->data8.data() + size_t(i) * C * H * W
                          : nullptr;
      for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
          int sx = mirror ? (W - 1 - x) : x;
          const uint8_t* px =
              hwc + (size_t(top + y) * w + (left + sx)) * 3;
          for (int c = 0; c < C && c < 3; ++c) {
            size_t at = nhwc ? (size_t(y) * W + x) * C + c
                             : (size_t(c) * H + y) * W + x;
            if (dst8) {
              dst8[at] = px[c];
            } else {
              float v = float(px[c]);
              if (cfg_.has_mean) v -= cfg_.mean[c];
              dst[at] = (v * con + ill) * cfg_.scale;
            }
          }
        }
      }
    }
    return true;
  }

  PipelineConfig cfg_;
  std::vector<int64_t> offsets_;
  std::vector<int64_t> order_;
  int fd_ = -1;
  bool ok_ = false;
  bool skip_decode_ = false;
  bool skip_work_ = false;
  int epoch_ = 0;

  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::map<int64_t, Batch> ready_;
  std::atomic<int64_t> ticket_counter_{0};
  int64_t tickets_total_ = 0;
  int64_t deliver_next_ = 0;
  bool failed_ = false;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

uint8_t* Copy(const std::vector<uint8_t>& v) {
  uint8_t* p = static_cast<uint8_t*>(std::malloc(std::max<size_t>(1, v.size())));
  if (p) std::memcpy(p, v.data(), v.size());
  return p;
}

}  // namespace

// ------------------------------------------------------------------- C ABI
extern "C" {

// Scan record offsets in a CREC file. Returns count (<= cap), or -1 on error.
int64_t mxtpu_scan_offsets(const char* path, int64_t* out, int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t count = 0;
  int64_t pos = 0;
  RecordHeader hdr;
  while (fread(&hdr, sizeof(hdr), 1, f) == 1) {
    if (hdr.magic != kRecordMagic) {
      fclose(f);
      return -1;
    }
    if (count < cap) out[count] = pos;
    ++count;
    int64_t padded = (hdr.length + 7) & ~int64_t(7);
    pos += sizeof(hdr) + padded;
    if (fseek(f, pos, SEEK_SET) != 0) break;
  }
  fclose(f);
  return count;
}

void* mxtpu_pipeline_create(const char* path, const int64_t* offsets,
                            int64_t n_offsets, int batch, int channels,
                            int height, int width, int label_width,
                            int rand_crop, int rand_mirror, int resize_short,
                            const float* mean3, float scale, int shuffle,
                            uint32_t seed, int num_threads, int prefetch,
                            int round_batch, int nhwc, int out_u8,
                            const float* aug6, int mirror) {
  // aug6 (nullable): {min_random_scale, max_random_scale, min_img_size,
  // max_img_size, max_random_contrast, max_random_illumination}
  PipelineConfig cfg;
  cfg.batch = batch;
  cfg.channels = channels;
  cfg.height = height;
  cfg.width = width;
  cfg.label_width = label_width;
  cfg.rand_crop = rand_crop;
  cfg.rand_mirror = rand_mirror;
  cfg.resize_short = resize_short;
  cfg.has_mean = mean3 != nullptr;
  if (mean3) std::memcpy(cfg.mean, mean3, sizeof(cfg.mean));
  cfg.scale = scale;
  cfg.shuffle = shuffle;
  cfg.seed = seed;
  cfg.num_threads = num_threads;
  cfg.prefetch = std::max(1, prefetch);
  cfg.round_batch = round_batch;
  cfg.nhwc = nhwc;
  cfg.out_u8 = out_u8;
  cfg.min_rscale = aug6 ? aug6[0] : 1.f;
  cfg.max_rscale = aug6 ? aug6[1] : 1.f;
  cfg.min_img = aug6 ? aug6[2] : 0.f;
  cfg.max_img = aug6 ? aug6[3] : 0.f;
  cfg.max_contrast = aug6 ? aug6[4] : 0.f;
  cfg.max_illum = aug6 ? aug6[5] : 0.f;
  cfg.mirror = mirror;
  auto* p = new ImagePipeline(path, offsets, n_offsets, cfg);
  if (!p->ok()) {
    delete p;
    return nullptr;
  }
  return p;
}

int mxtpu_pipeline_next(void* handle, void* data_out, float* label_out,
                        int* pad_out) {
  return static_cast<ImagePipeline*>(handle)->Next(data_out, label_out,
                                                   pad_out);
}

void mxtpu_pipeline_reset(void* handle) {
  static_cast<ImagePipeline*>(handle)->Reset();
}

int64_t mxtpu_pipeline_batches(void* handle) {
  return static_cast<ImagePipeline*>(handle)->BatchesPerEpoch();
}

void mxtpu_pipeline_destroy(void* handle) {
  delete static_cast<ImagePipeline*>(handle);
}

// Decode JPEG bytes to HWC RGB u8 in a malloc'ed buffer (free it with
// mxtpu_free). Returns 0, or -1 when the codec does not take the bytes.
int mxtpu_jpeg_decode(const uint8_t* buf, int64_t len, uint8_t** out,
                      int* height, int* width) {
  std::vector<uint8_t> px;
  if (len <= 0 || !jpeg::Decode(buf, size_t(len), &px, height, width))
    return -1;
  *out = Copy(px);
  return *out ? 0 : -1;
}

// Encode HWC u8 (1 or 3 channels) as baseline JPEG in a malloc'ed buffer
// (free it with mxtpu_free). Returns the byte count, or -1.
int64_t mxtpu_jpeg_encode(const uint8_t* pixels, int height, int width,
                          int channels, int quality, uint8_t** out) {
  std::vector<uint8_t> bytes;
  if (!jpeg::Encode(pixels, height, width, channels, quality, &bytes))
    return -1;
  *out = Copy(bytes);
  return *out ? int64_t(bytes.size()) : -1;
}

void mxtpu_free(void* p) { std::free(p); }

}  // extern "C"
