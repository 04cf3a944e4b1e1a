// Native forward-only predictor for exported bundles: the port's copy of
// the JAX package's native/mxtpu_predict.cc. Bundles written by either
// package's Predictor.export() run here. It stays a CPU runtime: it has no
// card path, as the JAX package's predictor has no TPU path.
//
// Reference counterpart: include/mxnet/c_predict_api.h +
// src/c_api/c_predict_api.cc (load symbol JSON + param blob, bind
// forward-only, set_input/forward/get_output) and amalgamation/ (the
// dependency-free single-library CPU predict build).  This is the same
// deployment surface for the framework: it consumes the
// single-file `.mxtpu` bundle written by `Predictor.export()` (a zip of
// symbol.json + params/*.npy + aux/*.npy) and runs the graph with plain
// C++ CPU kernels — no Python, no framework, no BLAS required.  Link deps:
// zlib (bundle inflate) and pthreads only.
//
// Exposed C ABI (mirrors MXPredCreate/SetInput/Forward/GetOutput):
//   mxtpu_pred_create / set_input / forward / num_outputs /
//   output_ndim / output_shape / get_output / free / last_error.

#include <zlib.h>

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Error reporting (TLS string, like the reference's c_api_error ring).
// ---------------------------------------------------------------------------
thread_local std::string g_last_error;

struct PredError {
  explicit PredError(std::string msg) : message(std::move(msg)) {}
  std::string message;
};

// ---------------------------------------------------------------------------
// Minimal JSON parser (objects, arrays, strings, numbers, bools, null).
// ---------------------------------------------------------------------------
struct Json {
  enum Type { kNull, kBool, kNumber, kString, kArray, kObject } type = kNull;
  bool b = false;
  double num = 0.0;
  std::string str;
  std::vector<Json> arr;
  std::vector<std::pair<std::string, Json>> obj;

  const Json* find(const std::string& key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& text) : s_(text) {}

  Json Parse() {
    Json v = ParseValue();
    SkipWs();
    if (pos_ != s_.size()) throw PredError("json: trailing characters");
    return v;
  }

 private:
  void SkipWs() {
    while (pos_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[pos_])))
      ++pos_;
  }
  char Peek() {
    SkipWs();
    if (pos_ >= s_.size()) throw PredError("json: unexpected end");
    return s_[pos_];
  }
  void Expect(char c) {
    if (Peek() != c)
      throw PredError(std::string("json: expected '") + c + "'");
    ++pos_;
  }
  Json ParseValue() {
    char c = Peek();
    switch (c) {
      case '{': return ParseObject();
      case '[': return ParseArray();
      case '"': { Json v; v.type = Json::kString; v.str = ParseString(); return v; }
      case 't': Literal("true");  { Json v; v.type = Json::kBool; v.b = true;  return v; }
      case 'f': Literal("false"); { Json v; v.type = Json::kBool; v.b = false; return v; }
      case 'n': Literal("null");  return Json();
      default:  return ParseNumber();
    }
  }
  void Literal(const char* lit) {
    size_t n = std::strlen(lit);
    if (s_.compare(pos_, n, lit) != 0) throw PredError("json: bad literal");
    pos_ += n;
  }
  std::string ParseString() {
    Expect('"');
    std::string out;
    while (true) {
      if (pos_ >= s_.size()) throw PredError("json: unterminated string");
      char c = s_[pos_++];
      if (c == '"') break;
      if (c == '\\') {
        if (pos_ >= s_.size()) throw PredError("json: bad escape");
        char e = s_[pos_++];
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            if (pos_ + 4 > s_.size()) throw PredError("json: bad \\u");
            unsigned code = std::stoul(s_.substr(pos_, 4), nullptr, 16);
            pos_ += 4;
            // Bundle text is ASCII in practice; encode BMP as UTF-8.
            if (code < 0x80) {
              out += static_cast<char>(code);
            } else if (code < 0x800) {
              out += static_cast<char>(0xC0 | (code >> 6));
              out += static_cast<char>(0x80 | (code & 0x3F));
            } else {
              out += static_cast<char>(0xE0 | (code >> 12));
              out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (code & 0x3F));
            }
            break;
          }
          default: throw PredError("json: bad escape");
        }
      } else {
        out += c;
      }
    }
    return out;
  }
  Json ParseNumber() {
    size_t start = pos_;
    while (pos_ < s_.size() &&
           (std::isdigit(static_cast<unsigned char>(s_[pos_])) ||
            strchr("+-.eE", s_[pos_]) != nullptr))
      ++pos_;
    Json v;
    v.type = Json::kNumber;
    try {
      v.num = std::stod(s_.substr(start, pos_ - start));
    } catch (...) {
      throw PredError("json: bad number");
    }
    return v;
  }
  Json ParseArray() {
    Expect('[');
    Json v;
    v.type = Json::kArray;
    if (Peek() == ']') { ++pos_; return v; }
    while (true) {
      v.arr.push_back(ParseValue());
      char c = Peek();
      if (c == ',') { ++pos_; continue; }
      if (c == ']') { ++pos_; break; }
      throw PredError("json: expected ',' or ']'");
    }
    return v;
  }
  Json ParseObject() {
    Expect('{');
    Json v;
    v.type = Json::kObject;
    if (Peek() == '}') { ++pos_; return v; }
    while (true) {
      std::string key = ParseString();
      Expect(':');
      v.obj.emplace_back(std::move(key), ParseValue());
      char c = Peek();
      if (c == ',') { ++pos_; continue; }
      if (c == '}') { ++pos_; break; }
      throw PredError("json: expected ',' or '}'");
    }
    return v;
  }

  const std::string& s_;
  size_t pos_ = 0;
};

// ---------------------------------------------------------------------------
// Zip reader (stored + deflate entries, via raw zlib inflate).
// ---------------------------------------------------------------------------
struct ZipEntry {
  std::string name;
  uint16_t method = 0;
  uint32_t comp_size = 0;
  uint32_t uncomp_size = 0;
  uint32_t local_offset = 0;
};

uint16_t ReadU16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t ReadU32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

class ZipReader {
 public:
  explicit ZipReader(std::vector<uint8_t> bytes) : buf_(std::move(bytes)) {
    ParseCentralDirectory();
  }

  std::vector<std::string> names() const {
    std::vector<std::string> out;
    for (const auto& e : entries_) out.push_back(e.first);
    return out;
  }

  bool has(const std::string& name) const { return entries_.count(name) != 0; }

  std::vector<uint8_t> Read(const std::string& name) const {
    auto it = entries_.find(name);
    if (it == entries_.end()) throw PredError("zip: no entry " + name);
    const ZipEntry& e = it->second;
    // Local header: 30 fixed bytes + name + extra.
    if (e.local_offset + 30 > buf_.size()) throw PredError("zip: bad offset");
    const uint8_t* lh = buf_.data() + e.local_offset;
    if (ReadU32(lh) != 0x04034b50) throw PredError("zip: bad local header");
    uint16_t nlen = ReadU16(lh + 26), xlen = ReadU16(lh + 28);
    size_t data_off = e.local_offset + 30 + nlen + xlen;
    if (data_off + e.comp_size > buf_.size()) throw PredError("zip: truncated");
    const uint8_t* data = buf_.data() + data_off;
    if (e.method == 0) {
      return std::vector<uint8_t>(data, data + e.comp_size);
    }
    if (e.method != 8) throw PredError("zip: unsupported method");
    std::vector<uint8_t> out(e.uncomp_size);
    z_stream strm;
    std::memset(&strm, 0, sizeof(strm));
    if (inflateInit2(&strm, -MAX_WBITS) != Z_OK)
      throw PredError("zip: inflateInit failed");
    strm.next_in = const_cast<uint8_t*>(data);
    strm.avail_in = e.comp_size;
    strm.next_out = out.data();
    strm.avail_out = e.uncomp_size;
    int rc = inflate(&strm, Z_FINISH);
    inflateEnd(&strm);
    if (rc != Z_STREAM_END) throw PredError("zip: inflate failed");
    return out;
  }

 private:
  void ParseCentralDirectory() {
    // Scan back for End Of Central Directory (sig 0x06054b50).
    if (buf_.size() < 22) throw PredError("zip: too small");
    size_t scan_limit = std::min<size_t>(buf_.size(), 22 + 65536);
    size_t eocd = SIZE_MAX;
    for (size_t back = 22; back <= scan_limit; ++back) {
      size_t pos = buf_.size() - back;
      if (ReadU32(buf_.data() + pos) == 0x06054b50) { eocd = pos; break; }
    }
    if (eocd == SIZE_MAX) throw PredError("zip: EOCD not found");
    uint16_t count = ReadU16(buf_.data() + eocd + 10);
    uint32_t cd_off = ReadU32(buf_.data() + eocd + 16);
    size_t pos = cd_off;
    for (uint16_t i = 0; i < count; ++i) {
      if (pos + 46 > buf_.size()) throw PredError("zip: bad central dir");
      const uint8_t* ch = buf_.data() + pos;
      if (ReadU32(ch) != 0x02014b50) throw PredError("zip: bad central sig");
      ZipEntry e;
      e.method = ReadU16(ch + 10);
      e.comp_size = ReadU32(ch + 20);
      e.uncomp_size = ReadU32(ch + 24);
      uint16_t nlen = ReadU16(ch + 28), xlen = ReadU16(ch + 30),
               clen = ReadU16(ch + 32);
      e.local_offset = ReadU32(ch + 42);
      e.name.assign(reinterpret_cast<const char*>(ch + 46), nlen);
      pos += 46 + nlen + xlen + clen;
      entries_[e.name] = e;
    }
  }

  std::vector<uint8_t> buf_;
  std::map<std::string, ZipEntry> entries_;
};

// ---------------------------------------------------------------------------
// Tensor + .npy loader (v1/v2 headers; numeric dtypes converted to f32).
// ---------------------------------------------------------------------------
struct Tensor {
  std::vector<int64_t> shape;
  std::vector<float> data;

  int64_t size() const {
    int64_t n = 1;
    for (int64_t d : shape) n *= d;
    return n;
  }
  bool defined() const { return !shape.empty() || !data.empty(); }
};

Tensor LoadNpy(const std::vector<uint8_t>& bytes) {
  if (bytes.size() < 10 || std::memcmp(bytes.data(), "\x93NUMPY", 6) != 0)
    throw PredError("npy: bad magic");
  uint8_t major = bytes[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = ReadU16(bytes.data() + 8);
    header_off = 10;
  } else {
    header_len = ReadU32(bytes.data() + 8);
    header_off = 12;
  }
  if (header_off + header_len > bytes.size())
    throw PredError("npy: truncated header");
  std::string header(reinterpret_cast<const char*>(bytes.data() + header_off),
                     header_len);
  auto grab = [&](const std::string& key) -> std::string {
    size_t k = header.find("'" + key + "'");
    if (k == std::string::npos) throw PredError("npy: no " + key);
    size_t c = header.find(':', k);
    return header.substr(c + 1);
  };
  std::string descr_part = grab("descr");
  size_t q1 = descr_part.find('\'');
  size_t q2 = descr_part.find('\'', q1 + 1);
  std::string descr = descr_part.substr(q1 + 1, q2 - q1 - 1);
  if (grab("fortran_order").find("True") != std::string::npos)
    throw PredError("npy: fortran order unsupported");
  std::string shp = grab("shape");
  size_t p1 = shp.find('('), p2 = shp.find(')');
  std::string inner = shp.substr(p1 + 1, p2 - p1 - 1);
  Tensor t;
  {
    size_t pos = 0;
    while (pos < inner.size()) {
      while (pos < inner.size() && !std::isdigit(static_cast<unsigned char>(inner[pos])))
        ++pos;
      if (pos >= inner.size()) break;
      size_t end = pos;
      while (end < inner.size() && std::isdigit(static_cast<unsigned char>(inner[end])))
        ++end;
      t.shape.push_back(std::stoll(inner.substr(pos, end - pos)));
      pos = end;
    }
  }
  int64_t n = t.size();
  t.data.resize(n);
  const uint8_t* payload = bytes.data() + header_off + header_len;
  size_t avail = bytes.size() - header_off - header_len;
  auto need = [&](size_t bytes_per) {
    if (avail < static_cast<size_t>(n) * bytes_per)
      throw PredError("npy: truncated payload");
  };
  if (descr == "<f4") {
    need(4);
    std::memcpy(t.data.data(), payload, n * 4);
  } else if (descr == "<f8") {
    need(8);
    const double* src = reinterpret_cast<const double*>(payload);
    for (int64_t i = 0; i < n; ++i) t.data[i] = static_cast<float>(src[i]);
  } else if (descr == "<i8") {
    need(8);
    const int64_t* src = reinterpret_cast<const int64_t*>(payload);
    for (int64_t i = 0; i < n; ++i) t.data[i] = static_cast<float>(src[i]);
  } else if (descr == "<i4") {
    need(4);
    const int32_t* src = reinterpret_cast<const int32_t*>(payload);
    for (int64_t i = 0; i < n; ++i) t.data[i] = static_cast<float>(src[i]);
  } else if (descr == "<u4") {
    need(4);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(payload);
    for (int64_t i = 0; i < n; ++i) t.data[i] = static_cast<float>(src[i]);
  } else if (descr == "|u1") {
    need(1);
    for (int64_t i = 0; i < n; ++i) t.data[i] = static_cast<float>(payload[i]);
  } else if (descr == "|i1") {
    need(1);
    const int8_t* src = reinterpret_cast<const int8_t*>(payload);
    for (int64_t i = 0; i < n; ++i) t.data[i] = static_cast<float>(src[i]);
  } else if (descr == "<f2") {
    need(2);
    const uint16_t* src = reinterpret_cast<const uint16_t*>(payload);
    for (int64_t i = 0; i < n; ++i) {
      // fp16 -> fp32
      uint16_t h = src[i];
      uint32_t sign = (h & 0x8000u) << 16;
      uint32_t exp = (h >> 10) & 0x1F;
      uint32_t mant = h & 0x3FF;
      uint32_t f;
      if (exp == 0) {
        if (mant == 0) {
          f = sign;
        } else {
          exp = 127 - 15 + 1;
          while ((mant & 0x400) == 0) { mant <<= 1; --exp; }
          mant &= 0x3FF;
          f = sign | (exp << 23) | (mant << 13);
        }
      } else if (exp == 31) {
        f = sign | 0x7F800000u | (mant << 13);
      } else {
        f = sign | ((exp - 15 + 127) << 23) | (mant << 13);
      }
      std::memcpy(&t.data[i], &f, 4);
    }
  } else {
    throw PredError("npy: unsupported dtype " + descr);
  }
  return t;
}

// ---------------------------------------------------------------------------
// Kernels.  Layout: NCHW, float32, row-major.
// ---------------------------------------------------------------------------

// C = A(mxk) * B(kxn), C preinitialized (bias or zero).
void Gemm(const float* A, const float* B, float* C, int64_t m, int64_t k,
          int64_t n) {
  for (int64_t i = 0; i < m; ++i) {
    const float* a = A + i * k;
    float* c = C + i * n;
    for (int64_t kk = 0; kk < k; ++kk) {
      float av = a[kk];
      if (av == 0.0f) continue;
      const float* b = B + kk * n;
      for (int64_t j = 0; j < n; ++j) c[j] += av * b[j];
    }
  }
}

Tensor FullyConnected(const Tensor& x, const Tensor& w, const Tensor* bias) {
  int64_t batch = x.shape[0];
  int64_t in_dim = x.size() / batch;
  int64_t out_dim = w.shape[0];
  if (w.size() != in_dim * out_dim)
    throw PredError("FullyConnected: weight shape mismatch");
  Tensor y;
  y.shape = {batch, out_dim};
  y.data.assign(batch * out_dim, 0.0f);
  // y = x * w^T : iterate j over out_dim with contiguous w rows.
  for (int64_t i = 0; i < batch; ++i) {
    const float* xi = x.data.data() + i * in_dim;
    float* yi = y.data.data() + i * out_dim;
    for (int64_t j = 0; j < out_dim; ++j) {
      const float* wj = w.data.data() + j * in_dim;
      float acc = 0.0f;
      for (int64_t kk = 0; kk < in_dim; ++kk) acc += xi[kk] * wj[kk];
      yi[j] = acc + (bias ? bias->data[j] : 0.0f);
    }
  }
  return y;
}

struct ConvParam {
  int64_t kh, kw, sh, sw, ph, pw, dh, dw, num_filter, num_group;
};

Tensor Convolution(const Tensor& x, const Tensor& w, const Tensor* bias,
                   const ConvParam& p) {
  int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
  int64_t kh_eff = p.dh * (p.kh - 1) + 1, kw_eff = p.dw * (p.kw - 1) + 1;
  int64_t OH = (H + 2 * p.ph - kh_eff) / p.sh + 1;
  int64_t OW = (W + 2 * p.pw - kw_eff) / p.sw + 1;
  int64_t G = p.num_group, Cg = C / G, Fg = p.num_filter / G;
  int64_t patch = Cg * p.kh * p.kw;
  Tensor y;
  y.shape = {N, p.num_filter, OH, OW};
  y.data.assign(N * p.num_filter * OH * OW, 0.0f);
  std::vector<float> col(patch * OH * OW);
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t g = 0; g < G; ++g) {
      // im2col for this (sample, group)
      float* cp = col.data();
      for (int64_t c = 0; c < Cg; ++c) {
        const float* img = x.data.data() + ((n * C + g * Cg + c) * H) * W;
        for (int64_t ki = 0; ki < p.kh; ++ki) {
          for (int64_t kj = 0; kj < p.kw; ++kj) {
            for (int64_t oi = 0; oi < OH; ++oi) {
              int64_t ii = oi * p.sh - p.ph + ki * p.dh;
              for (int64_t oj = 0; oj < OW; ++oj) {
                int64_t jj = oj * p.sw - p.pw + kj * p.dw;
                *cp++ = (ii >= 0 && ii < H && jj >= 0 && jj < W)
                            ? img[ii * W + jj]
                            : 0.0f;
              }
            }
          }
        }
      }
      // weights[g]: (Fg, patch) @ col: (patch, OH*OW)
      float* out = y.data.data() + ((n * p.num_filter + g * Fg) * OH) * OW;
      if (bias) {
        for (int64_t f = 0; f < Fg; ++f)
          std::fill(out + f * OH * OW, out + (f + 1) * OH * OW,
                    bias->data[g * Fg + f]);
      }
      Gemm(w.data.data() + g * Fg * patch, col.data(), out, Fg, patch,
           OH * OW);
    }
  }
  return y;
}

Tensor Pooling(const Tensor& x, int64_t kh, int64_t kw, int64_t sh, int64_t sw,
               int64_t ph, int64_t pw, const std::string& type,
               bool global_pool) {
  int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
  if (global_pool) { kh = H; kw = W; sh = sw = 1; ph = pw = 0; }
  int64_t OH = (H + 2 * ph - kh) / sh + 1;
  int64_t OW = (W + 2 * pw - kw) / sw + 1;
  Tensor y;
  y.shape = {N, C, OH, OW};
  y.data.assign(N * C * OH * OW, 0.0f);
  bool is_max = type == "max";
  bool is_avg = type == "avg";
  for (int64_t nc = 0; nc < N * C; ++nc) {
    const float* img = x.data.data() + nc * H * W;
    float* out = y.data.data() + nc * OH * OW;
    for (int64_t oi = 0; oi < OH; ++oi) {
      for (int64_t oj = 0; oj < OW; ++oj) {
        int64_t i0 = oi * sh - ph, j0 = oj * sw - pw;
        float acc = is_max ? -3.402823e38f : 0.0f;
        for (int64_t ki = 0; ki < kh; ++ki) {
          int64_t ii = i0 + ki;
          if (ii < 0 || ii >= H) continue;
          for (int64_t kj = 0; kj < kw; ++kj) {
            int64_t jj = j0 + kj;
            if (jj < 0 || jj >= W) continue;
            float v = img[ii * W + jj];
            acc = is_max ? std::max(acc, v) : acc + v;
          }
        }
        if (is_avg) acc /= static_cast<float>(kh * kw);
        out[oi * OW + oj] = acc;
      }
    }
  }
  return y;
}

Tensor BatchNormInference(const Tensor& x, const Tensor& gamma,
                          const Tensor& beta, const Tensor& mean,
                          const Tensor& var, float eps) {
  int64_t N = x.shape[0], C = x.shape[1];
  int64_t spatial = x.size() / (N * C);
  Tensor y;
  y.shape = x.shape;
  y.data.resize(x.data.size());
  for (int64_t c = 0; c < C; ++c) {
    float inv = 1.0f / std::sqrt(var.data[c] + eps);
    float g = gamma.data[c] * inv;
    float b = beta.data[c] - mean.data[c] * g;
    for (int64_t n = 0; n < N; ++n) {
      const float* src = x.data.data() + (n * C + c) * spatial;
      float* dst = y.data.data() + (n * C + c) * spatial;
      for (int64_t i = 0; i < spatial; ++i) dst[i] = src[i] * g + b;
    }
  }
  return y;
}

Tensor Lrn(const Tensor& x, int64_t nsize, float alpha, float beta,
           float knorm) {
  int64_t N = x.shape[0], C = x.shape[1];
  int64_t spatial = x.size() / (N * C);
  Tensor y;
  y.shape = x.shape;
  y.data.resize(x.data.size());
  int64_t half = nsize / 2;
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t c = 0; c < C; ++c) {
      for (int64_t i = 0; i < spatial; ++i) {
        float acc = 0.0f;
        for (int64_t cc = std::max<int64_t>(0, c - half);
             cc <= std::min(C - 1, c + half); ++cc) {
          float v = x.data[(n * C + cc) * spatial + i];
          acc += v * v;
        }
        float scale = std::pow(knorm + alpha * acc / nsize, -beta);
        y.data[(n * C + c) * spatial + i] =
            x.data[(n * C + c) * spatial + i] * scale;
      }
    }
  }
  return y;
}

Tensor SoftmaxAxis1(const Tensor& x, bool multi_output) {
  Tensor y;
  y.shape = x.shape;
  y.data.resize(x.data.size());
  int64_t N = x.shape[0];
  int64_t C = x.shape.size() > 1 ? x.shape[1] : 1;
  int64_t spatial = x.size() / (N * C);
  (void)multi_output;  // axis-1 softmax covers both layouts (spatial=1 for 2D)
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t s = 0; s < spatial; ++s) {
      float maxv = -3.402823e38f;
      for (int64_t c = 0; c < C; ++c)
        maxv = std::max(maxv, x.data[(n * C + c) * spatial + s]);
      float sum = 0.0f;
      for (int64_t c = 0; c < C; ++c) {
        float e = std::exp(x.data[(n * C + c) * spatial + s] - maxv);
        y.data[(n * C + c) * spatial + s] = e;
        sum += e;
      }
      for (int64_t c = 0; c < C; ++c)
        y.data[(n * C + c) * spatial + s] /= sum;
    }
  }
  return y;
}

// ---------------------------------------------------------------------------
// Graph + executor.
// ---------------------------------------------------------------------------
struct GraphNode {
  std::string op;       // canonical name from JSON ("null", "Convolution", ...)
  std::string name;
  std::vector<std::pair<int, int>> inputs;  // (node_id, output_index)
  Json param;           // object (may be empty)
};

int64_t JInt(const Json& j) { return static_cast<int64_t>(j.num); }

struct Predictor {
  std::vector<GraphNode> nodes;
  std::vector<std::pair<int, int>> heads;
  std::map<std::string, Tensor> params;   // arg + aux tensors by name
  std::map<std::string, Tensor> inputs;   // user-set inputs by name
  std::vector<std::string> input_names;   // from manifest
  std::vector<Tensor> outputs;

  const Json* Param(const GraphNode& n, const char* key) const {
    return n.param.type == Json::kObject ? n.param.find(key) : nullptr;
  }
  int64_t IParam(const GraphNode& n, const char* key, int64_t dflt) const {
    const Json* p = Param(n, key);
    return p ? JInt(*p) : dflt;
  }
  double FParam(const GraphNode& n, const char* key, double dflt) const {
    const Json* p = Param(n, key);
    return p ? p->num : dflt;
  }
  bool BParam(const GraphNode& n, const char* key, bool dflt) const {
    const Json* p = Param(n, key);
    return p ? (p->type == Json::kBool ? p->b : p->num != 0) : dflt;
  }
  std::string SParam(const GraphNode& n, const char* key,
                     const std::string& dflt) const {
    const Json* p = Param(n, key);
    return p ? p->str : dflt;
  }
  std::vector<int64_t> TParam(const GraphNode& n, const char* key) const {
    const Json* p = Param(n, key);
    std::vector<int64_t> out;
    if (p && p->type == Json::kArray)
      for (const Json& v : p->arr) out.push_back(JInt(v));
    return out;
  }

  void Forward();
};

Tensor Elementwise(const std::vector<Tensor>& ins, char op) {
  Tensor y = ins[0];
  for (size_t i = 1; i < ins.size(); ++i) {
    if (ins[i].data.size() != y.data.size())
      throw PredError("elementwise: shape mismatch");
    for (size_t j = 0; j < y.data.size(); ++j) {
      switch (op) {
        case '+': y.data[j] += ins[i].data[j]; break;
        case '-': y.data[j] -= ins[i].data[j]; break;
        case '*': y.data[j] *= ins[i].data[j]; break;
        case '/': y.data[j] /= ins[i].data[j]; break;
      }
    }
  }
  return y;
}

Tensor Unary(const Tensor& x, float (*fn)(float)) {
  Tensor y;
  y.shape = x.shape;
  y.data.resize(x.data.size());
  for (size_t i = 0; i < x.data.size(); ++i) y.data[i] = fn(x.data[i]);
  return y;
}

void Predictor::Forward() {
  std::vector<std::vector<Tensor>> vals(nodes.size());
  for (size_t idx = 0; idx < nodes.size(); ++idx) {
    const GraphNode& nd = nodes[idx];
    const std::string& op = nd.op;
    if (op == "null") {
      auto it = inputs.find(nd.name);
      if (it != inputs.end()) {
        vals[idx] = {it->second};
        continue;
      }
      auto pit = params.find(nd.name);
      if (pit != params.end()) {
        vals[idx] = {pit->second};
        continue;
      }
      // Unbound variable (e.g. a label) — leave undefined; output-layer
      // ops never read their label at inference.
      vals[idx] = {Tensor()};
      continue;
    }
    std::vector<const Tensor*> in;
    for (const auto& e : nd.inputs) in.push_back(&vals[e.first][e.second]);
    auto arg = [&](size_t i) -> const Tensor& {
      if (i >= in.size() || !in[i]->defined())
        throw PredError(op + " '" + nd.name + "': missing input " +
                        std::to_string(i));
      return *in[i];
    };
    std::vector<Tensor> out;

    if (op == "FullyConnected") {
      bool no_bias = BParam(nd, "no_bias", false);
      out.push_back(FullyConnected(arg(0), arg(1), no_bias ? nullptr : &arg(2)));
    } else if (op == "Convolution") {
      auto kernel = TParam(nd, "kernel");
      auto stride = TParam(nd, "stride");
      auto pad = TParam(nd, "pad");
      auto dilate = TParam(nd, "dilate");
      ConvParam p;
      p.kh = kernel[0]; p.kw = kernel[1];
      p.sh = stride.empty() ? 1 : stride[0];
      p.sw = stride.empty() ? 1 : stride[1];
      p.ph = pad.empty() ? 0 : pad[0];
      p.pw = pad.empty() ? 0 : pad[1];
      p.dh = dilate.empty() ? 1 : dilate[0];
      p.dw = dilate.empty() ? 1 : dilate[1];
      p.num_filter = IParam(nd, "num_filter", 0);
      p.num_group = IParam(nd, "num_group", 1);
      bool no_bias = BParam(nd, "no_bias", false);
      out.push_back(Convolution(arg(0), arg(1), no_bias ? nullptr : &arg(2), p));
    } else if (op == "Pooling") {
      auto kernel = TParam(nd, "kernel");
      auto stride = TParam(nd, "stride");
      auto pad = TParam(nd, "pad");
      out.push_back(Pooling(
          arg(0), kernel.empty() ? 1 : kernel[0], kernel.empty() ? 1 : kernel[1],
          stride.empty() ? 1 : stride[0], stride.empty() ? 1 : stride[1],
          pad.empty() ? 0 : pad[0], pad.empty() ? 0 : pad[1],
          SParam(nd, "pool_type", "max"), BParam(nd, "global_pool", false)));
    } else if (op == "Activation") {
      std::string t = SParam(nd, "act_type", "relu");
      const Tensor& x = arg(0);
      if (t == "relu") {
        out.push_back(Unary(x, [](float v) { return v > 0 ? v : 0.0f; }));
      } else if (t == "sigmoid") {
        out.push_back(Unary(x, [](float v) { return 1.0f / (1.0f + std::exp(-v)); }));
      } else if (t == "tanh") {
        out.push_back(Unary(x, [](float v) { return std::tanh(v); }));
      } else if (t == "softrelu") {
        out.push_back(Unary(x, [](float v) { return std::log1p(std::exp(v)); }));
      } else {
        throw PredError("Activation: unknown act_type " + t);
      }
    } else if (op == "LeakyReLU") {
      std::string t = SParam(nd, "act_type", "leaky");
      float slope = static_cast<float>(FParam(nd, "slope", 0.25));
      const Tensor& x = arg(0);
      Tensor y;
      y.shape = x.shape;
      y.data.resize(x.data.size());
      if (t == "prelu") {
        const Tensor& gamma = arg(1);
        int64_t N = x.shape[0], C = x.shape[1];
        int64_t spatial = x.size() / (N * C);
        for (int64_t n = 0; n < N; ++n)
          for (int64_t c = 0; c < C; ++c)
            for (int64_t i = 0; i < spatial; ++i) {
              float v = x.data[(n * C + c) * spatial + i];
              y.data[(n * C + c) * spatial + i] =
                  v > 0 ? v : v * gamma.data[c];
            }
      } else if (t == "elu") {
        for (size_t i = 0; i < x.data.size(); ++i) {
          float v = x.data[i];
          y.data[i] = v > 0 ? v : slope * (std::exp(v) - 1.0f);
        }
      } else {  // leaky; rrelu at inference uses mean slope of bounds
        if (t == "rrelu")
          slope = static_cast<float>((FParam(nd, "lower_bound", 0.125) +
                                      FParam(nd, "upper_bound", 0.334)) / 2.0);
        for (size_t i = 0; i < x.data.size(); ++i) {
          float v = x.data[i];
          y.data[i] = v > 0 ? v : v * slope;
        }
      }
      out.push_back(std::move(y));
    } else if (op == "BatchNorm") {
      float eps = static_cast<float>(FParam(nd, "eps", 1e-3));
      auto mit = params.find(nd.name + "_moving_mean");
      auto vit = params.find(nd.name + "_moving_var");
      if (mit == params.end() || vit == params.end())
        throw PredError("BatchNorm '" + nd.name + "': missing moving stats");
      Tensor gamma = arg(1);
      if (BParam(nd, "fix_gamma", false))
        std::fill(gamma.data.begin(), gamma.data.end(), 1.0f);
      out.push_back(BatchNormInference(arg(0), gamma, arg(2), mit->second,
                                       vit->second, eps));
    } else if (op == "LRN") {
      out.push_back(Lrn(arg(0), IParam(nd, "nsize", 5),
                        static_cast<float>(FParam(nd, "alpha", 1e-4)),
                        static_cast<float>(FParam(nd, "beta", 0.75)),
                        static_cast<float>(FParam(nd, "knorm", 2.0))));
    } else if (op == "Flatten") {
      Tensor y = arg(0);
      int64_t batch = y.shape[0];
      y.shape = {batch, y.size() / batch};
      out.push_back(std::move(y));
    } else if (op == "Reshape") {
      Tensor y = arg(0);
      auto target = TParam(nd, "target_shape");
      // Same resolution as ReshapeOp._resolve: only a LEADING 0 keeps the
      // batch dim; a single -1 is inferred from the remaining size.
      std::vector<int64_t> shp;
      int64_t known = 1;
      int infer = -1;
      for (size_t i = 0; i < target.size(); ++i) {
        int64_t d = target[i];
        if (i == 0 && d == 0) d = y.shape[0];
        if (d == -1) {
          if (infer >= 0) throw PredError("Reshape: multiple -1 dims");
          infer = static_cast<int>(i);
          shp.push_back(-1);
          continue;
        }
        if (d <= 0) throw PredError("Reshape: bad target dim");
        shp.push_back(d);
        known *= d;
      }
      if (infer >= 0) shp[infer] = y.size() / known;
      int64_t total = 1;
      for (int64_t d : shp) total *= d;
      if (total != y.size()) throw PredError("Reshape: size mismatch");
      y.shape = shp;
      out.push_back(std::move(y));
    } else if (op == "Concat") {
      int64_t dim = IParam(nd, "dim", 1);
      std::vector<const Tensor*> xs;
      for (size_t i = 0; i < nd.inputs.size(); ++i) xs.push_back(&arg(i));
      Tensor y;
      y.shape = xs[0]->shape;
      int64_t total = 0;
      for (auto* t : xs) total += t->shape[dim];
      y.shape[dim] = total;
      y.data.resize(y.size());
      int64_t outer = 1, inner = 1;
      for (int64_t i = 0; i < dim; ++i) outer *= y.shape[i];
      for (size_t i = dim + 1; i < y.shape.size(); ++i) inner *= y.shape[i];
      int64_t off = 0;
      for (auto* t : xs) {
        int64_t rows = t->shape[dim];
        for (int64_t o = 0; o < outer; ++o) {
          std::memcpy(y.data.data() + (o * total + off) * inner,
                      t->data.data() + o * rows * inner,
                      rows * inner * sizeof(float));
        }
        off += rows;
      }
      out.push_back(std::move(y));
    } else if (op == "SliceChannel") {
      int64_t num = IParam(nd, "num_outputs", 1);
      int64_t axis = IParam(nd, "axis", 1);
      bool squeeze = BParam(nd, "squeeze_axis", false);
      const Tensor& x = arg(0);
      int64_t rows = x.shape[axis] / num;
      int64_t outer = 1, inner = 1;
      for (int64_t i = 0; i < axis; ++i) outer *= x.shape[i];
      for (size_t i = axis + 1; i < x.shape.size(); ++i) inner *= x.shape[i];
      for (int64_t s = 0; s < num; ++s) {
        Tensor y;
        y.shape = x.shape;
        y.shape[axis] = rows;
        if (squeeze && rows == 1)
          y.shape.erase(y.shape.begin() + axis);
        y.data.resize(outer * rows * inner);
        for (int64_t o = 0; o < outer; ++o)
          std::memcpy(y.data.data() + o * rows * inner,
                      x.data.data() + (o * x.shape[axis] + s * rows) * inner,
                      rows * inner * sizeof(float));
        out.push_back(std::move(y));
      }
    } else if (op == "ElementWiseSum" || op == "add_n") {
      std::vector<Tensor> xs;
      for (size_t i = 0; i < nd.inputs.size(); ++i) xs.push_back(arg(i));
      out.push_back(Elementwise(xs, '+'));
    } else if (op == "_Plus" || op == "elemwise_add") {
      out.push_back(Elementwise({arg(0), arg(1)}, '+'));
    } else if (op == "_Minus") {
      out.push_back(Elementwise({arg(0), arg(1)}, '-'));
    } else if (op == "_Mul") {
      out.push_back(Elementwise({arg(0), arg(1)}, '*'));
    } else if (op == "_Div") {
      out.push_back(Elementwise({arg(0), arg(1)}, '/'));
    } else if (op == "SoftmaxOutput" || op == "Softmax") {
      out.push_back(SoftmaxAxis1(arg(0), BParam(nd, "multi_output", false)));
    } else if (op == "LinearRegressionOutput" || op == "MAERegressionOutput" ||
               op == "BlockGrad" || op == "Dropout") {
      out.push_back(arg(0));
    } else if (op == "LogisticRegressionOutput") {
      out.push_back(Unary(arg(0), [](float v) { return 1.0f / (1.0f + std::exp(-v)); }));
    } else if (op == "Embedding") {
      const Tensor& idx_t = arg(0);
      const Tensor& w = arg(1);
      int64_t out_dim = w.shape[1];
      Tensor y;
      y.shape = idx_t.shape;
      y.shape.push_back(out_dim);
      y.data.resize(idx_t.size() * out_dim);
      for (int64_t i = 0; i < idx_t.size(); ++i) {
        // Clip OOV ids like the framework's Embedding (a clipped take).
        int64_t row = static_cast<int64_t>(idx_t.data[i]);
        row = std::max<int64_t>(0, std::min(row, w.shape[0] - 1));
        std::memcpy(y.data.data() + i * out_dim, w.data.data() + row * out_dim,
                    out_dim * sizeof(float));
      }
      out.push_back(std::move(y));
    } else if (op == "Transpose") {
      const Tensor& x = arg(0);
      auto axes = TParam(nd, "axes");
      size_t nd_dims = x.shape.size();
      if (axes.empty())
        for (size_t i = 0; i < nd_dims; ++i)
          axes.push_back(static_cast<int64_t>(nd_dims - 1 - i));
      Tensor y;
      y.shape.resize(nd_dims);
      for (size_t i = 0; i < nd_dims; ++i) y.shape[i] = x.shape[axes[i]];
      y.data.resize(x.data.size());
      std::vector<int64_t> xstride(nd_dims, 1), ystride(nd_dims, 1);
      for (int64_t i = nd_dims - 2; i >= 0; --i)
        xstride[i] = xstride[i + 1] * x.shape[i + 1];
      for (int64_t i = nd_dims - 2; i >= 0; --i)
        ystride[i] = ystride[i + 1] * y.shape[i + 1];
      std::vector<int64_t> idx(nd_dims, 0);
      for (int64_t flat = 0; flat < x.size(); ++flat) {
        int64_t rem = flat, src = 0;
        for (size_t i = 0; i < nd_dims; ++i) {
          idx[i] = rem / ystride[i];
          rem %= ystride[i];
        }
        for (size_t i = 0; i < nd_dims; ++i) src += idx[i] * xstride[axes[i]];
        y.data[flat] = x.data[src];
      }
      out.push_back(std::move(y));
    } else if (op == "square") {
      out.push_back(Unary(arg(0), [](float v) { return v * v; }));
    } else if (op == "sqrt") {
      out.push_back(Unary(arg(0), [](float v) { return std::sqrt(v); }));
    } else if (op == "exp") {
      out.push_back(Unary(arg(0), [](float v) { return std::exp(v); }));
    } else if (op == "log") {
      out.push_back(Unary(arg(0), [](float v) { return std::log(v); }));
    } else if (op == "abs") {
      out.push_back(Unary(arg(0), [](float v) { return std::fabs(v); }));
    } else if (op == "norm") {
      const Tensor& x = arg(0);
      double acc = 0.0;
      for (float v : x.data) acc += static_cast<double>(v) * v;
      Tensor y;
      y.shape = {1};
      y.data = {static_cast<float>(std::sqrt(acc))};
      out.push_back(std::move(y));
    } else {
      throw PredError("unsupported op at inference: " + op);
    }
    vals[idx] = std::move(out);
  }
  outputs.clear();
  for (const auto& h : heads) outputs.push_back(vals[h.first][h.second]);
}

std::vector<uint8_t> ReadFile(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) throw PredError(std::string("cannot open ") + path);
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  size_t got = std::fread(buf.data(), 1, sz, f);
  std::fclose(f);
  if (got != static_cast<size_t>(sz)) throw PredError("short read");
  return buf;
}

Predictor* CreateFromBundle(const char* path) {
  ZipReader zip(ReadFile(path));
  auto pred = std::make_unique<Predictor>();
  std::vector<uint8_t> sym_bytes = zip.Read("symbol.json");
  std::string sym(reinterpret_cast<const char*>(sym_bytes.data()),
                  sym_bytes.size());
  Json graph = JsonParser(sym).Parse();
  const Json* nodes = graph.find("nodes");
  const Json* heads = graph.find("heads");
  if (!nodes || !heads) throw PredError("symbol.json: missing nodes/heads");
  for (const Json& jn : nodes->arr) {
    GraphNode n;
    n.op = jn.find("op") ? jn.find("op")->str : "null";
    n.name = jn.find("name") ? jn.find("name")->str : "";
    if (const Json* ins = jn.find("inputs"))
      for (const Json& e : ins->arr)
        n.inputs.emplace_back(static_cast<int>(JInt(e.arr[0])),
                              static_cast<int>(JInt(e.arr[1])));
    if (const Json* p = jn.find("param")) n.param = *p;
    pred->nodes.push_back(std::move(n));
  }
  for (const Json& h : heads->arr)
    pred->heads.emplace_back(static_cast<int>(JInt(h.arr[0])),
                             static_cast<int>(JInt(h.arr[1])));
  std::vector<uint8_t> man_bytes = zip.Read("manifest.json");
  std::string manifest_text(reinterpret_cast<const char*>(man_bytes.data()),
                            man_bytes.size());
  Json manifest = JsonParser(manifest_text).Parse();
  if (const Json* in = manifest.find("inputs"))
    for (const Json& v : in->arr) pred->input_names.push_back(v.str);
  for (const std::string& name : zip.names()) {
    bool is_param = name.rfind("params/", 0) == 0;
    bool is_aux = name.rfind("aux/", 0) == 0;
    if (!is_param && !is_aux) continue;
    std::string key = name.substr(name.find('/') + 1);
    if (key.size() > 4 && key.substr(key.size() - 4) == ".npy")
      key = key.substr(0, key.size() - 4);
    pred->params[key] = LoadNpy(zip.Read(name));
  }
  return pred.release();
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

const char* mxtpu_pred_last_error() { return g_last_error.c_str(); }

void* mxtpu_pred_create(const char* bundle_path) {
  try {
    return CreateFromBundle(bundle_path);
  } catch (const PredError& e) {
    g_last_error = e.message;
    return nullptr;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return nullptr;
  }
}

int mxtpu_pred_set_input(void* handle, const char* name, const float* data,
                         const int64_t* shape, int ndim) {
  try {
    auto* p = static_cast<Predictor*>(handle);
    Tensor t;
    t.shape.assign(shape, shape + ndim);
    t.data.assign(data, data + t.size());
    p->inputs[name] = std::move(t);
    return 0;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return -1;
  }
}

int mxtpu_pred_forward(void* handle) {
  auto* p = static_cast<Predictor*>(handle);
  try {
    p->Forward();
    return 0;
  } catch (const PredError& e) {
    g_last_error = e.message;
    return -1;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return -1;
  }
}

int mxtpu_pred_num_outputs(void* handle) {
  return static_cast<int>(static_cast<Predictor*>(handle)->outputs.size());
}

int mxtpu_pred_output_ndim(void* handle, int index) {
  auto* p = static_cast<Predictor*>(handle);
  if (index < 0 || index >= static_cast<int>(p->outputs.size())) return -1;
  return static_cast<int>(p->outputs[index].shape.size());
}

int mxtpu_pred_output_shape(void* handle, int index, int64_t* shape_out) {
  auto* p = static_cast<Predictor*>(handle);
  if (index < 0 || index >= static_cast<int>(p->outputs.size())) return -1;
  const Tensor& t = p->outputs[index];
  for (size_t i = 0; i < t.shape.size(); ++i) shape_out[i] = t.shape[i];
  return 0;
}

int64_t mxtpu_pred_get_output(void* handle, int index, float* out,
                              int64_t cap) {
  auto* p = static_cast<Predictor*>(handle);
  if (index < 0 || index >= static_cast<int>(p->outputs.size())) {
    g_last_error = "output index out of range";
    return -1;
  }
  const Tensor& t = p->outputs[index];
  int64_t n = t.size();
  if (cap < n) {
    g_last_error = "output buffer too small";
    return -1;
  }
  std::memcpy(out, t.data.data(), n * sizeof(float));
  return n;
}

void mxtpu_pred_free(void* handle) { delete static_cast<Predictor*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Standalone CLI (amalgamation-style deployment): no Python.
//   mxtpu_predict model.mxtpu input.npy [input_name]
// Prints each output head's shape and leading values.
// ---------------------------------------------------------------------------
#ifdef MXTPU_PREDICT_MAIN
#include <cstdio>

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s model.mxtpu input.npy [input_name]\n",
                 argv[0]);
    return 2;
  }
  const char* input_name = argc > 3 ? argv[3] : "data";
  try {
    std::unique_ptr<Predictor> pred(CreateFromBundle(argv[1]));
    Tensor in = LoadNpy(ReadFile(argv[2]));
    pred->inputs[input_name] = std::move(in);
    pred->Forward();
    for (size_t i = 0; i < pred->outputs.size(); ++i) {
      const Tensor& t = pred->outputs[i];
      std::printf("output[%zu] shape=(", i);
      for (size_t d = 0; d < t.shape.size(); ++d)
        std::printf("%s%lld", d ? "," : "",
                    static_cast<long long>(t.shape[d]));
      std::printf(") values=[");
      int64_t show = std::min<int64_t>(t.size(), 8);
      for (int64_t j = 0; j < show; ++j)
        std::printf("%s%.6g", j ? ", " : "", t.data[j]);
      std::printf("%s]\n", t.size() > show ? ", ..." : "");
    }
    return 0;
  } catch (const PredError& e) {
    std::fprintf(stderr, "error: %s\n", e.message.c_str());
    return 1;
  }
}
#endif  // MXTPU_PREDICT_MAIN
