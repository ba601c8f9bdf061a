// Baseline JPEG decode and encode for the port's data layer, part of the
// native host library (built with stereo_native.cpp by data/native.py).
//
// The JAX package reads frames with cv2.imread(path, IMREAD_COLOR), which
// decodes with libjpeg-turbo's defaults: the accurate integer IDCT
// (jidctint.c), fancy (triangle) upsampling of subsampled chroma
// (jdsample.c) and the fixed-point YCbCr -> RGB tables (jdcolor.c). This
// decoder repeats that arithmetic, so it gives cv2's pixels bit for bit.
//
// Decoded: sequential Huffman JPEGs of 8-bit samples (SOF0, SOF1), with 1
// (gray) or 3 (YCbCr) components, sampling factors 1-4, 8- or 16-bit
// quantization tables, Huffman tables defined per scan, restart intervals,
// interleaved or one-component scans, and any image size. Everything else
// (progressive, lossless, hierarchical, arithmetic coding, 12-bit samples,
// 4 components, Adobe RGB) is refused with a message naming it.
//
// Encoded: baseline JFIF of RGB images (4:4:4, 4:2:2 or 4:2:0) with the
// Annex K tables scaled by the quality as
// libjpeg scales them (jcparam.c), RGB -> YCbCr (jccolor.c), box
// downsampling with libjpeg's alternating bias (jcsample.c), the accurate
// integer FDCT (jfdctint.c) and the standard Huffman tables.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// Zigzag position -> natural (row-major) index, padded as libjpeg pads it
// so that a corrupt run length cannot index past the block.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The signed value of the s bits r (jdhuff.h HUFF_EXTEND).
inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (-1 << s) + 1 : r; }

// ---------------------------------------------------------------------------
// Huffman decoding tables (jdhuff.c jpeg_make_d_derived_tbl).
// ---------------------------------------------------------------------------
constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0 = longer code
  // For an AC table: a run/size symbol whose code and value bits both fit
  // in the lookahead, decoded whole: (value << 16) | (run << 8) | bits used;
  // 0 = take the general path.
  int32_t fast_ac[1 << kLookBits];

  void build(const uint8_t* bits, const uint8_t* values, int nvals) {
    memcpy(vals, values, nvals);
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < bits[l - 1]; i++, p++) {
        int pad = kLookBits - l;
        int base = huffcode[p] << pad;
        for (int c = 0; c < (1 << pad); c++)
          look[base + c] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    for (int i = 0; i < (1 << kLookBits); i++) {
      fast_ac[i] = 0;
      const int l = look[i] >> 8, rs = look[i] & 0xFF, run = rs >> 4, size = rs & 15;
      if (l && size && l + size <= kLookBits) {
        const int bits = (i >> (kLookBits - l - size)) & ((1 << size) - 1);
        fast_ac[i] = static_cast<int32_t>(static_cast<uint32_t>(extend(bits, size)) << 16) |
                     (run << 8) | (l + size);
      }
    }
    defined = true;
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded data: bytes with 0xFF00 stuffing, ending at a marker.
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  BitReader(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        if (*p != 0xFF) {
          b = *p++;
        } else if (p + 1 < end && p[1] == 0x00) {
          b = 0xFF;
          p += 2;
        } else {
          at_marker = true;  // zeros from here on, as libjpeg inserts
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }

  int peek(int n) {
    if (cnt < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }

  int decode(const HuffTable& t) {
    if (cnt < 16) fill();
    int e = t.look[buf >> (64 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; l++) {
      int code = static_cast<int>(buf >> (64 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(t.valoffset[l] + code) & 0xFF];
      }
    }
    fail("corrupt JPEG: bad Huffman code");
  }

  // Drop the bits left in the byte-aligned segment and step over the
  // restart marker RSTn (fill bytes 0xFF before it allowed).
  void restart(int n) {
    buf = 0;
    cnt = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) p++;
    if (p + 1 >= end || p[1] != 0xD0 + n) fail("corrupt JPEG: missing restart marker");
    p += 2;
  }
};

// ---------------------------------------------------------------------------
// Inverse DCT (jidctint.c jpeg_idct_islow) and the sample range limit of
// jdmaster.c prepare_range_limit_table.
// ---------------------------------------------------------------------------
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t idct[1024];  // indexed by (value & 1023); value + 128 clamped
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) idct[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) idct[i] = 255;
      else if (i < 896) idct[i] = 0;
      else idct[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = (in[0] * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * qq[16], z3 = in[48] * qq[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * qq[0];
    z3 = in[32] * qq[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qq[56];
    tmp1 = in[40] * qq[40];
    tmp2 = in[24] * qq[24];
    tmp3 = in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
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
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.idct[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.idct[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.idct[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.idct[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.idct[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.idct[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.idct[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.idct[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ---------------------------------------------------------------------------
// Decoder.
// ---------------------------------------------------------------------------
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;  // samples of the image in this component
  int bw = 0, bh = 0;  // blocks of the coefficient array (MCU-padded)
  bool seen = false;
  uint16_t q[64];
  std::vector<int16_t> coef;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame = false, jfif = false;
  int adobe_transform = -1;
  int scans = 0;
  std::vector<Component> comps;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int byte() {
    if (pos >= n) fail("corrupt JPEG: data ends early");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // The body of a marker segment: [pos, end) after its length.
  size_t segment_end() {
    int len = word();
    if (len < 2 || pos + len - 2 > n) fail("corrupt JPEG: bad segment length");
    return pos + len - 2;
  }
  int next_marker() {
    for (;;) {
      while (pos < n && data[pos] != 0xFF) pos++;
      while (pos < n && data[pos] == 0xFF) pos++;
      if (pos >= n) return -1;
      int m = data[pos++];
      if (m != 0) return m;
    }
  }

  void read_sof(int marker) {
    size_t end = segment_end();
    int precision = byte();
    height = word();
    width = word();
    int nc = byte();
    if (precision != 8)
      fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples (SOF" +
           std::to_string(marker - 0xC0) + ")");
    if (nc != 1 && nc != 3)
      fail("unsupported JPEG: " + std::to_string(nc) + " components");
    if (width <= 0 || height <= 0) fail("unsupported JPEG: image size 0 (DNL)");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad component in SOF");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    pos = end;
    mcux = ceil_div(width, 8 * hmax);
    mcuy = ceil_div(height, 8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) fail("unsupported JPEG: fractional sampling factors");
      c.dw = ceil_div(width * c.h, hmax);
      c.dh = ceil_div(height * c.v, vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    frame = true;
  }

  void read_dqt() {
    size_t end = segment_end();
    while (pos < end) {
      int pq = byte();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3 || prec > 1) fail("corrupt JPEG: bad DQT");
      for (int k = 0; k < 64; k++)
        qt[t][kNatural[k]] = static_cast<uint16_t>(prec ? word() : byte());
      qt_defined[t] = true;
    }
    pos = end;
  }

  void read_dht() {
    size_t end = segment_end();
    while (pos < end) {
      int tc = byte();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) fail("corrupt JPEG: bad DHT");
      uint8_t bits[16], vals[256];
      int total = 0;
      for (int i = 0; i < 16; i++) total += bits[i] = static_cast<uint8_t>(byte());
      if (total > 256) fail("corrupt JPEG: bad DHT");
      for (int i = 0; i < total; i++) vals[i] = static_cast<uint8_t>(byte());
      (cls ? ac : dc)[t].build(bits, vals, total);
    }
    pos = end;
  }

  void read_app(int marker) {
    size_t end = segment_end();
    size_t len = end - pos;
    const uint8_t* b = data + pos;
    if (marker == 0xE0 && len >= 5 && !memcmp(b, "JFIF\0", 5)) jfif = true;
    if (marker == 0xEE && len >= 12 && !memcmp(b, "Adobe", 5)) adobe_transform = b[11];
    pos = end;
  }

  void decode_block(BitReader& br, const HuffTable& dct, const HuffTable& act, int& pred,
                    int16_t* blk) {
    int s = br.decode(dct);
    if (s) {
      if (s > 16) fail("corrupt JPEG: bad DC coefficient");
      s = extend(br.get(s), s);
    }
    pred += s;
    blk[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; k++) {
      if (br.cnt < 16) br.fill();
      const int32_t fast = act.fast_ac[br.buf >> (64 - kLookBits)];
      if (fast) {
        br.skip(fast & 0xFF);
        k += (fast >> 8) & 0xFF;
        blk[kNatural[k]] = static_cast<int16_t>(fast >> 16);
        continue;
      }
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void read_sos() {
    if (!frame) fail("corrupt JPEG: SOS before SOF");
    size_t end = segment_end();
    int ns = byte();
    if (ns < 1 || ns > 4) fail("corrupt JPEG: bad SOS");
    std::vector<int> idx(ns), td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      int cid = byte(), t = byte();
      idx[i] = -1;
      for (size_t c = 0; c < comps.size(); c++)
        if (comps[c].id == cid) idx[i] = static_cast<int>(c);
      if (idx[i] < 0) fail("corrupt JPEG: SOS names an unknown component");
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) fail("corrupt JPEG: bad SOS");
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("corrupt JPEG: spectral selection in a sequential scan");
    pos = end;
    for (int i = 0; i < ns; i++) {
      Component& c = comps[idx[i]];
      if (!dc[td[i]].defined || !ac[ta[i]].defined)
        fail("corrupt JPEG: Huffman table not defined");
      if (!c.seen) {
        if (!qt_defined[c.tq])
          fail("corrupt JPEG: quantization table " + std::to_string(c.tq) + " not defined");
        memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
        c.seen = true;
      }
    }
    std::vector<int> pred(ns, 0);
    BitReader br(data + pos, data + n);
    int restarts = 0;
    if (ns == 1) {
      Component& c = comps[idx[0]];
      int bx = ceil_div(c.dw, 8), by = ceil_div(c.dh, 8);
      long total = static_cast<long>(bx) * by;
      for (long m = 0; m < total; m++) {
        if (restart_interval && m && m % restart_interval == 0) {
          br.restart(restarts++ & 7);
          pred[0] = 0;
        }
        int y = static_cast<int>(m / bx), x = static_cast<int>(m % bx);
        decode_block(br, dc[td[0]], ac[ta[0]], pred[0],
                     &c.coef[(static_cast<size_t>(y) * c.bw + x) * 64]);
      }
    } else {
      long total = static_cast<long>(mcux) * mcuy;
      for (long m = 0; m < total; m++) {
        if (restart_interval && m && m % restart_interval == 0) {
          br.restart(restarts++ & 7);
          std::fill(pred.begin(), pred.end(), 0);
        }
        int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
        for (int i = 0; i < ns; i++) {
          Component& c = comps[idx[i]];
          for (int v = 0; v < c.v; v++)
            for (int h = 0; h < c.h; h++) {
              size_t b = static_cast<size_t>(my * c.v + v) * c.bw + mx * c.h + h;
              decode_block(br, dc[td[i]], ac[ta[i]], pred[i], &c.coef[b * 64]);
            }
        }
      }
    }
    pos = static_cast<size_t>(br.p - data);
    scans++;
  }

  // Markers up to the frame header (header_only) or to EOI.
  void parse(bool header_only) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0 || m == 0xD9) break;
      switch (m) {
        case 0xC0: case 0xC1:
          if (frame) fail("corrupt JPEG: two frames");
          read_sof(m);
          if (header_only) return;
          break;
        case 0xC2: fail("unsupported JPEG: progressive (SOF2)");
        case 0xC3: fail("unsupported JPEG: lossless (SOF3)");
        case 0xC5: case 0xC6: case 0xC7:
          fail("unsupported JPEG: hierarchical (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("unsupported JPEG: arithmetic coding (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xCC: fail("unsupported JPEG: arithmetic coding (DAC)");
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: {
          size_t end = segment_end();
          restart_interval = word();
          pos = end;
          break;
        }
        case 0xDA:
          if (header_only) fail("corrupt JPEG: SOS before SOF");
          read_sos();
          break;
        case 0xD8: case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7: case 0x01:
          break;  // no segment
        default:
          if (m >= 0xE0 && m <= 0xEF) read_app(m);
          else pos = segment_end();
      }
    }
    if (!frame) fail("corrupt JPEG: no frame header");
    if (header_only) return;
    if (!scans) fail("corrupt JPEG: no scan");
    if (comps.size() == 3) {
      bool rgb_ids = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
      if (adobe_transform == 0 || (!jfif && adobe_transform < 0 && rgb_ids))
        fail("unsupported JPEG: Adobe RGB (untransformed) components");
    }
    for (auto& c : comps)
      if (!c.seen) fail("corrupt JPEG: a component has no scan");
  }

  // Dequantize, inverse DCT and upsample component `c` to (height, width).
  void component_plane(const Component& c, uint8_t* full) const {
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.bh * 8);
    const int by = ceil_div(c.dh, 8), bx = ceil_div(c.dw, 8);
    for (int y = 0; y < by; y++)
      for (int x = 0; x < bx; x++)
        idct_islow(&c.coef[(static_cast<size_t>(y) * c.bw + x) * 64], c.q,
                   &plane[static_cast<size_t>(y) * 8 * stride + x * 8], stride);
    const int hr = hmax / c.h, vr = vmax / c.v;
    const int W = width, H = height, dw = c.dw, dh = c.dh;
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
      return &plane[static_cast<size_t>(r) * stride];
    };
    std::vector<int> sums(dw);
    std::vector<uint8_t> line(2 * static_cast<size_t>(dw));
    for (int y = 0; y < H; y++) {
      uint8_t* o = full + static_cast<size_t>(y) * W;
      if (hr == 1 && vr == 1) {
        memcpy(o, row(y), W);
      } else if (hr == 2 && vr == 1 && dw > 2) {  // jdsample.c h2v1_fancy_upsample
        const uint8_t* in = row(y);
        uint8_t* p = line.data();
        p[0] = in[0];
        p[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int j = 1; j < dw - 1; j++) {
          int v = in[j] * 3;
          p[2 * j] = static_cast<uint8_t>((v + in[j - 1] + 1) >> 2);
          p[2 * j + 1] = static_cast<uint8_t>((v + in[j + 1] + 2) >> 2);
        }
        p[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        p[2 * dw - 1] = in[dw - 1];
        memcpy(o, p, W);
      } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        const int r = y >> 1, v = y & 1;
        const uint8_t* near = row(r);
        const uint8_t* far = row(v ? r + 1 : r - 1);
        const int bias = v ? 2 : 1;
        for (int x = 0; x < W; x++)
          o[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
        const int r = y >> 1, v = y & 1;
        const uint8_t* near = row(r);
        const uint8_t* far = row(v ? r + 1 : r - 1);
        for (int j = 0; j < dw; j++) sums[j] = near[j] * 3 + far[j];
        uint8_t* p = line.data();
        p[0] = static_cast<uint8_t>((sums[0] * 4 + 8) >> 4);
        p[1] = static_cast<uint8_t>((sums[0] * 3 + sums[1] + 7) >> 4);
        for (int j = 1; j < dw - 1; j++) {
          const int t = sums[j] * 3;
          p[2 * j] = static_cast<uint8_t>((t + sums[j - 1] + 8) >> 4);
          p[2 * j + 1] = static_cast<uint8_t>((t + sums[j + 1] + 7) >> 4);
        }
        p[2 * dw - 2] = static_cast<uint8_t>((sums[dw - 1] * 3 + sums[dw - 2] + 8) >> 4);
        p[2 * dw - 1] = static_cast<uint8_t>((sums[dw - 1] * 4 + 7) >> 4);
        memcpy(o, p, W);
      } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
        const uint8_t* in = row(y / vr);
        for (int x = 0; x < W; x++) o[x] = in[x / hr];
      }
    }
  }

  void to_rgb(uint8_t* out) const {
    const size_t npix = static_cast<size_t>(width) * height;
    std::vector<uint8_t> planes(npix * comps.size());
    for (size_t c = 0; c < comps.size(); c++) component_plane(comps[c], &planes[c * npix]);
    if (comps.size() == 1) {
      for (size_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes[i];
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert (SCALEBITS 16). The
    // green sum fits in 32 bits, so int32 gives libjpeg's JLONG result.
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    const int one_half = 1 << 15;
    for (int i = 0; i < 256; i++) {
      const int x = i - 128;
      cr_r[i] = (91881 * x + one_half) >> 16;
      cb_b[i] = (116130 * x + one_half) >> 16;
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + one_half;
    }
    uint8_t limit[3 * 256];  // jdmaster.c's simple range limit, from -256
    for (int i = 0; i < 3 * 256; i++)
      limit[i] = static_cast<uint8_t>(std::min(std::max(i - 256, 0), 255));
    const uint8_t* lim = limit + 256;
    const uint8_t* Y = planes.data();
    const uint8_t* Cb = Y + npix;
    const uint8_t* Cr = Cb + npix;
    for (size_t i = 0; i < npix; i++) {
      const int y = Y[i], cb = Cb[i], cr = Cr[i];
      uint8_t* o = out + 3 * i;
      o[0] = lim[y + cr_r[cr]];
      o[1] = lim[y + ((cb_g[cb] + cr_g[cr]) >> 16)];
      o[2] = lim[y + cb_b[cb]];
    }
  }
};

void copy_error(const std::string& msg, char* err, int64_t errlen) {
  if (!err || errlen <= 0) return;
  size_t k = std::min(msg.size(), static_cast<size_t>(errlen - 1));
  memcpy(err, msg.data(), k);
  err[k] = 0;
}

// ---------------------------------------------------------------------------
// Encoder.
// ---------------------------------------------------------------------------
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
  HuffCodes(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof(size));
    int p = 0, c = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, p++) {
        code[vals[p]] = static_cast<uint16_t>(c++);
        size[vals[p]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    cnt += n;
    while (cnt >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
  void flush() {
    if (cnt) put(0x7F, 8 - cnt);  // pad with ones
  }
};

// jfdctint.c jpeg_fdct_islow: the output is scaled up by 8.
void fdct_islow(int* d) {
  for (int r = 0; r < 8; r++) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, kConstBits - kPass1Bits));
    p[6] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, kConstBits - kPass1Bits));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(descale(tmp4 + z1 + z3, kConstBits - kPass1Bits));
    p[5] = static_cast<int>(descale(tmp5 + z2 + z4, kConstBits - kPass1Bits));
    p[3] = static_cast<int>(descale(tmp6 + z2 + z3, kConstBits - kPass1Bits));
    p[1] = static_cast<int>(descale(tmp7 + z1 + z4, kConstBits - kPass1Bits));
  }
  for (int c = 0; c < 8; c++) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits + kPass1Bits;
    p[16] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[48] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(descale(tmp4 + z1 + z3, sh));
    p[40] = static_cast<int>(descale(tmp5 + z2 + z4, sh));
    p[24] = static_cast<int>(descale(tmp6 + z2 + z3, sh));
    p[8] = static_cast<int>(descale(tmp7 + z1 + z4, sh));
  }
}

void put_word(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int tc, const uint8_t* bits, const uint8_t* vals) {
  int total = 0;
  for (int i = 0; i < 16; i++) total += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put_word(o, 2 + 1 + 16 + total);
  o.push_back(static_cast<uint8_t>(tc));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + total);
}

void encode_block(BitWriter& bw, const int* coef, int& pred, const HuffCodes& dct,
                  const HuffCodes& act) {
  auto nbits = [](int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
      n++;
      a >>= 1;
    }
    return n;
  };
  int diff = coef[0] - pred;
  pred = coef[0];
  int s = nbits(diff);
  bw.put(dct.code[s], dct.size[s]);
  if (s) bw.put(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = coef[kNatural[k]];
    if (!v) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    s = nbits(v);
    int rs = (run << 4) | s;
    bw.put(act.code[rs], act.size[rs]);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run) bw.put(act.code[0], act.size[0]);
}

// Baseline JFIF of an (H, W, 3) RGB image; luma sampled (hs, vs) against
// chroma's (1, 1): (1, 1) 4:4:4, (2, 1) 4:2:2, (2, 2) 4:2:0.
std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int quality, int hs, int vs) {
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[2][64];
  for (int i = 0; i < 64; i++) {
    long lq = (kStdLumaQ[i] * static_cast<long>(scale) + 50) / 100;
    long cq = (kStdChromaQ[i] * static_cast<long>(scale) + 50) / 100;
    q[0][i] = static_cast<uint16_t>(lq < 1 ? 1 : (lq > 255 ? 255 : lq));
    q[1][i] = static_cast<uint16_t>(cq < 1 ? 1 : (cq > 255 ? 255 : cq));
  }
  const int mcux = ceil_div(W, 8 * hs), mcuy = ceil_div(H, 8 * vs);
  const int PW = mcux * 8 * hs, PH = mcuy * 8 * vs;
  const size_t plane = static_cast<size_t>(PW) * PH;
  // Full-resolution Y, Cb, Cr padded to whole MCUs by repeating the last
  // column and row (jcsample.c expand_right_edge, jcprepct.c
  // expand_bottom_edge).
  std::vector<uint8_t> full(3 * plane);
  int32_t tab[8 * 256];  // jccolor.c rgb_ycc_start
  const int32_t half = 1 << 15, cbcr_off = 128 << 16;
  for (int i = 0; i < 256; i++) {
    tab[i] = 19595 * i;
    tab[256 + i] = 38470 * i;
    tab[512 + i] = 7471 * i + half;
    tab[768 + i] = -11059 * i;
    tab[1024 + i] = -21709 * i;
    tab[1280 + i] = 32768 * i + cbcr_off + half - 1;
    tab[1536 + i] = -27439 * i;
    tab[1792 + i] = -5329 * i;
  }
  for (int y = 0; y < PH; y++) {
    const int sy = y < H ? y : H - 1;
    for (int x = 0; x < PW; x++) {
      const int sx = x < W ? x : W - 1;
      const uint8_t* px = img + (static_cast<size_t>(sy) * W + sx) * 3;
      const size_t i = static_cast<size_t>(y) * PW + x;
      const int r = px[0], g = px[1], b = px[2];
      full[i] = static_cast<uint8_t>((tab[r] + tab[256 + g] + tab[512 + b]) >> 16);
      full[plane + i] = static_cast<uint8_t>((tab[768 + r] + tab[1024 + g] + tab[1280 + b]) >> 16);
      full[2 * plane + i] =
          static_cast<uint8_t>((tab[1280 + r] + tab[1536 + g] + tab[1792 + b]) >> 16);
    }
  }
  // Chroma at (PW / hs, PH / vs): jcsample.c's h2v2 (bias 1, 2, 1, ...) and
  // h2v1 (bias 0, 1, 0, ...) box averages.
  const int CW = PW / hs, CH = PH / vs, n = hs * vs, shift = n / 2;
  std::vector<uint8_t> chroma(2 * static_cast<size_t>(CW) * CH);
  for (int c = 0; c < 2; c++) {
    const uint8_t* src = &full[(1 + c) * plane];
    uint8_t* dst = &chroma[c * static_cast<size_t>(CW) * CH];
    for (int y = 0; y < CH; y++) {
      int bias = n == 4 ? 1 : 0;
      for (int x = 0; x < CW; x++) {
        int sum = 0;
        for (int dy = 0; dy < vs; dy++)
          for (int dx = 0; dx < hs; dx++)
            sum += src[static_cast<size_t>(y * vs + dy) * PW + x * hs + dx];
        dst[static_cast<size_t>(y) * CW + x] = static_cast<uint8_t>((sum + bias) >> shift);
        bias ^= n - 1;
      }
    }
  }

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(W) * H + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  const uint8_t app0[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), app0, app0 + sizeof(app0));
  for (int t = 0; t < 2; t++) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put_word(o, 67);
    o.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; k++) o.push_back(static_cast<uint8_t>(q[t][kNatural[k]]));
  }
  const uint8_t sof[] = {0xFF, 0xC0, 0, 17, 8,
                         static_cast<uint8_t>(H >> 8), static_cast<uint8_t>(H & 0xFF),
                         static_cast<uint8_t>(W >> 8), static_cast<uint8_t>(W & 0xFF), 3,
                         1, static_cast<uint8_t>((hs << 4) | vs), 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), sof, sof + sizeof(sof));
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(o, 0x01, kDcChromaBits, kDcVals);
  put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + sizeof(sos));

  const HuffCodes dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals);
  const HuffCodes dcc(kDcChromaBits, kDcVals), acc(kAcChromaBits, kAcChromaVals);
  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  int blk[64];
  auto block = [&](const uint8_t* src, int stride, int x0, int y0, int t, int& p,
                   const HuffCodes& dct, const HuffCodes& act) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++)
        blk[8 * y + x] = src[static_cast<size_t>(y0 + y) * stride + x0 + x] - 128;
    fdct_islow(blk);
    for (int i = 0; i < 64; i++) {  // jcdctmgr.c: divide by 8 * q, rounded
      const int qv = q[t][i] * 8;
      int v = blk[i];
      if (v < 0) {
        v = -v + (qv >> 1);
        v = v >= qv ? -(v / qv) : 0;
      } else {
        v += qv >> 1;
        v = v >= qv ? v / qv : 0;
      }
      blk[i] = v;
    }
    encode_block(bw, blk, p, dct, act);
  };
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++) {
      for (int v = 0; v < vs; v++)
        for (int h = 0; h < hs; h++)
          block(full.data(), PW, (mx * hs + h) * 8, (my * vs + v) * 8, 0, pred[0], dcl, acl);
      for (int c = 0; c < 2; c++)
        block(&chroma[c * static_cast<size_t>(CW) * CH], CW, mx * 8, my * 8, 1, pred[1 + c],
              dcc, acc);
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace

extern "C" {

// Decode a JPEG held in `data` (n bytes). With out == nullptr only the
// frame header is read: *h and *w get the image size. Else `out` receives
// (*h, *w, 3) RGB bytes (gray repeated), for the *h and *w of the header
// call. Returns 0, or 1 with a message in err (errlen bytes).
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t* h, int64_t* w,
                char* err, int64_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.parse(out == nullptr);
    if (out == nullptr) {
      *h = d.height;
      *w = d.width;
      return 0;
    }
    if (*h != d.height || *w != d.width) fail("JPEG size differs from its header call");
    d.to_rgb(out);
    return 0;
  } catch (const JpegError& e) {
    copy_error(e.msg, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(std::string("JPEG decode failed: ") + e.what(), err, errlen);
    return 1;
  }
}

// Encode an (h, w, 3) uint8 RGB image as baseline JFIF at `quality` with
// luma sampling factors (hs, vs) = (1, 1), (2, 1) or (2, 2) against
// chroma's (1, 1). Writes at most cap bytes to out and returns the encoded
// size; a size larger than cap means nothing was written. Returns -1 on a
// bad argument.
int64_t jpeg_encode(const uint8_t* img, int64_t h, int64_t w, int quality, int hs, int vs,
                    uint8_t* out, int64_t cap) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535 || hs < 1 || hs > 2 || vs < 1 || vs > hs)
    return -1;
  try {
    std::vector<uint8_t> bytes =
        encode(img, static_cast<int>(h), static_cast<int>(w), quality, hs, vs);
    const int64_t size = static_cast<int64_t>(bytes.size());
    if (size <= cap) memcpy(out, bytes.data(), bytes.size());
    return size;
  } catch (const std::exception&) {
    return -1;
  }
}

}  // extern "C"
