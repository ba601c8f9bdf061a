// The native host library of the port's data path: PFM decode, half-pixel
// bilinear resize, uint8 -> float32 normalization and the point-cloud voxel
// grid of the serving engine. A copy of the JAX package's native library
// (native/stereo_native.cpp), function for function, so both packages give
// the same bits; the port never loads the JAX package's build.
//
// One function more than the JAX package's library: crc32c, the checksum of
// the TensorBoard event files the port writes and reads
// (utils/event_file.py); the JAX package leaves those to tensorboardX.
//
// Built with the host C++ compiler at first use by
// adaptive_stereo_tpu_torch/data/native.py ($CXX, else c++; -O3 -fPIC
// -shared -std=c++17 -ffp-contract=off) and called through ctypes. Plain
// C ABI, no Python or PyTorch headers.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <algorithm>
#include <array>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PFM decode (SceneFlow disparity format: 'Pf'/'PF' header, W H, signed
// scale encoding endianness, rows stored bottom-up).
// Returns 0 on success; fills *out_h, *out_w, *out_c. If `data` is null, only
// probes the header so the caller can allocate. Data is written top-down.
// ---------------------------------------------------------------------------
int pfm_read(const char* path, float* data, int64_t* out_h, int64_t* out_w,
             int64_t* out_c) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  char header[8] = {0};
  if (!fgets(header, sizeof(header), f)) { fclose(f); return -2; }
  int channels;
  if (header[0] == 'P' && header[1] == 'F') channels = 3;
  else if (header[0] == 'P' && header[1] == 'f') channels = 1;
  else { fclose(f); return -3; }

  long w = 0, h = 0;
  if (fscanf(f, "%ld %ld", &w, &h) != 2 || w <= 0 || h <= 0) { fclose(f); return -4; }
  float scale = 0.f;
  if (fscanf(f, "%f", &scale) != 1) { fclose(f); return -5; }
  // Consume single whitespace after the scale line.
  fgetc(f);

  *out_h = h; *out_w = w; *out_c = channels;
  if (data == nullptr) { fclose(f); return 0; }

  const size_t count = (size_t)w * h * channels;
  std::vector<float> raw(count);
  if (fread(raw.data(), sizeof(float), count, f) != count) { fclose(f); return -6; }
  fclose(f);

  const bool file_little = scale < 0.f;
  uint16_t probe = 1;
  const bool host_little = *reinterpret_cast<uint8_t*>(&probe) == 1;
  if (file_little != host_little) {
    for (size_t i = 0; i < count; i++) {
      uint32_t v;
      memcpy(&v, &raw[i], 4);
      v = __builtin_bswap32(v);
      memcpy(&raw[i], &v, 4);
    }
  }
  // Flip rows: PFM is bottom-up.
  const size_t row = (size_t)w * channels;
  for (long y = 0; y < h; y++)
    memcpy(data + (size_t)y * row, raw.data() + (size_t)(h - 1 - y) * row,
           row * sizeof(float));
  return 0;
}

// ---------------------------------------------------------------------------
// Half-pixel-center bilinear resize, float32 HWC (torch
// F.interpolate(align_corners=False) / cv2.resize INTER_LINEAR semantics).
// ---------------------------------------------------------------------------
void resize_bilinear_f32(const float* src, int64_t sh, int64_t sw, int64_t c,
                         float* dst, int64_t dh, int64_t dw) {
  const double sy = (double)sh / dh;
  const double sx = (double)sw / dw;
  std::vector<int64_t> x0s(dw), x1s(dw);
  std::vector<float> wxs(dw);
  for (int64_t x = 0; x < dw; x++) {
    double fx = (x + 0.5) * sx - 0.5;
    fx = std::max(0.0, std::min(fx, (double)sw - 1));
    int64_t x0 = (int64_t)fx;
    x0s[x] = x0;
    x1s[x] = std::min(x0 + 1, sw - 1);
    wxs[x] = (float)(fx - x0);
  }
  for (int64_t y = 0; y < dh; y++) {
    double fy = (y + 0.5) * sy - 0.5;
    fy = std::max(0.0, std::min(fy, (double)sh - 1));
    int64_t y0 = (int64_t)fy;
    int64_t y1 = std::min(y0 + 1, sh - 1);
    float wy = (float)(fy - y0);
    const float* r0 = src + y0 * sw * c;
    const float* r1 = src + y1 * sw * c;
    float* out = dst + y * dw * c;
    for (int64_t x = 0; x < dw; x++) {
      const float wx = wxs[x];
      const float* p00 = r0 + x0s[x] * c;
      const float* p01 = r0 + x1s[x] * c;
      const float* p10 = r1 + x0s[x] * c;
      const float* p11 = r1 + x1s[x] * c;
      for (int64_t ch = 0; ch < c; ch++) {
        float top = p00[ch] + wx * (p01[ch] - p00[ch]);
        float bot = p10[ch] + wx * (p11[ch] - p10[ch]);
        out[x * c + ch] = top + wy * (bot - top);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// uint8 HWC -> float32 HWC /255 conversion (image normalize).
// ---------------------------------------------------------------------------
void u8_to_f32_scaled(const uint8_t* src, float* dst, int64_t n) {
  constexpr float kInv = 1.0f / 255.0f;
  for (int64_t i = 0; i < n; i++) dst[i] = src[i] * kInv;
}

// ---------------------------------------------------------------------------
// Voxel downsample: average points (and optional colors) per voxel.
// Returns the number of voxels written (capped at max_out).
// ---------------------------------------------------------------------------
int64_t voxel_downsample_f32(const float* pts, const float* cols, int64_t n,
                             float voxel, float* out_pts, float* out_cols,
                             int64_t max_out) {
  struct Key {
    int64_t x, y, z;
    bool operator==(const Key& o) const { return x == o.x && y == o.y && z == o.z; }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return (size_t)(k.x * 73856093LL ^ k.y * 19349663LL ^ k.z * 83492791LL);
    }
  };
  struct Acc { double px, py, pz, cr, cg, cb; int64_t count; };
  std::unordered_map<Key, Acc, KeyHash> vox;
  vox.reserve((size_t)n);
  const double inv = 1.0 / voxel;
  for (int64_t i = 0; i < n; i++) {
    Key k{(int64_t)std::floor(pts[3 * i] * inv),
          (int64_t)std::floor(pts[3 * i + 1] * inv),
          (int64_t)std::floor(pts[3 * i + 2] * inv)};
    Acc& a = vox[k];
    a.px += pts[3 * i]; a.py += pts[3 * i + 1]; a.pz += pts[3 * i + 2];
    if (cols) { a.cr += cols[3 * i]; a.cg += cols[3 * i + 1]; a.cb += cols[3 * i + 2]; }
    a.count++;
  }
  int64_t out = 0;
  for (const auto& kv : vox) {
    if (out >= max_out) break;
    const Acc& a = kv.second;
    out_pts[3 * out] = (float)(a.px / a.count);
    out_pts[3 * out + 1] = (float)(a.py / a.count);
    out_pts[3 * out + 2] = (float)(a.pz / a.count);
    if (cols && out_cols) {
      out_cols[3 * out] = (float)(a.cr / a.count);
      out_cols[3 * out + 1] = (float)(a.cg / a.count);
      out_cols[3 * out + 2] = (float)(a.cb / a.count);
    }
    out++;
  }
  return out;
}

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of n bytes,
// continuing from `crc` (0 for a new checksum): the checksum of TFRecord
// framing. Byte-at-a-time through a 256-entry table.
// ---------------------------------------------------------------------------
uint32_t crc32c_update(uint32_t crc, const uint8_t* data, int64_t n) {
  static const std::array<uint32_t, 256> table = [] {  // built once, thread-safe
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1u) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  crc = ~crc;
  for (int64_t i = 0; i < n; i++) crc = table[(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
  return ~crc;
}

}  // extern "C"
