// Host batch decoder: a pool of threads that decodes 8-bit PPM/PGM, BMP and
// raw RGB8 files, resizes each bilinearly to the training resolution and
// scales it to [0, 1] float32, straight into the caller's (n, H, W, 3) batch;
// and the channel-wise minimum of a stack of views.
//
// The counterpart of the JAX package's native/loader.cc (its decoders at
// :40-160, ResizeNormalize at :170-201, shmgan_estimate_diffuse at
// :308-316), written anew for the port: it
// accepts and refuses the same files and repeats the same float32 arithmetic
// in the same order. One deliberate difference: a PNM of maxval below 255 is
// scaled to 8 bits as PIL scales it (round(v / maxval * 255), half to even,
// capped at 255), where loader.cc copies the samples unscaled. The build
// turns off floating-point contraction (-ffp-contract=off), so every f32
// operation rounds on its own and the plain numpy version in
// runtime/native_loader.py gives the same bits.
//
// Two refusals loader.cc lacks, both for headers whose sizes overflow its
// arithmetic (it would then read past the file): a raw blob or a BMP whose
// raster size does not fit in size_t, and dimensions above INT_MAX.
//
// Plain C interface for ctypes; no PyTorch header.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iterator>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, 8-bit
  bool ok = false;
};

// Binary PPM (P6) and PGM (P5) of maxval <= 255.
Image DecodePNM(const std::string& bytes) {
  Image img;
  if (bytes.size() < 2 || bytes[0] != 'P') return img;
  const int channels = bytes[1] == '6' ? 3 : (bytes[1] == '5' ? 1 : 0);
  if (channels == 0) return img;
  size_t pos = 2;
  auto next_int = [&](int* out) -> bool {
    while (pos < bytes.size()) {  // whitespace and '#' comments
      if (isspace(static_cast<unsigned char>(bytes[pos]))) {
        ++pos;
      } else if (bytes[pos] == '#') {
        while (pos < bytes.size() && bytes[pos] != '\n') ++pos;
      } else {
        break;
      }
    }
    int v = 0;
    bool any = false;
    while (pos < bytes.size() && isdigit(static_cast<unsigned char>(bytes[pos]))) {
      v = v * 10 + (bytes[pos] - '0');
      if (v > (1 << 24)) return false;  // bounds dimensions and maxval
      ++pos;
      any = true;
    }
    *out = v;
    return any;
  };
  int w, h, maxval;
  if (!next_int(&w) || !next_int(&h) || !next_int(&maxval)) return img;
  if (maxval <= 0 || maxval > 255 || w <= 0 || h <= 0) return img;
  ++pos;  // the one whitespace byte after maxval
  const size_t need = static_cast<size_t>(w) * h * channels;
  if (pos > bytes.size() || bytes.size() - pos < need) return img;
  img.w = w;
  img.h = h;
  img.c = channels;
  img.data.assign(bytes.begin() + pos, bytes.begin() + pos + need);
  if (maxval != 255) {  // PIL's scaling, in double as numpy computes it
    uint8_t lut[256];
    for (int v = 0; v < 256; ++v) {
      const double t = std::nearbyint(static_cast<double>(v) / maxval * 255.0);
      lut[v] = static_cast<uint8_t>(t > 255.0 ? 255.0 : t);
    }
    for (uint8_t& s : img.data) s = lut[s];
  }
  img.ok = true;
  return img;
}

// Uncompressed 24/32-bit BMP at the fixed BITMAPINFOHEADER offsets,
// bottom-up or top-down.
Image DecodeBMP(const std::string& b) {
  Image img;
  if (b.size() < 54 || b[0] != 'B' || b[1] != 'M') return img;
  auto u32 = [&](size_t off) {
    uint32_t v;
    std::memcpy(&v, b.data() + off, 4);
    return v;
  };
  auto s32 = [&](size_t off) {
    int32_t v;
    std::memcpy(&v, b.data() + off, 4);
    return v;
  };
  auto u16 = [&](size_t off) {
    uint16_t v;
    std::memcpy(&v, b.data() + off, 2);
    return v;
  };
  const uint32_t data_off = u32(10);
  const int32_t w = s32(18), h = s32(22);
  const uint16_t bpp = u16(28);
  const uint32_t compression = u32(30);
  if (compression != 0 || (bpp != 24 && bpp != 32) || w <= 0 || h == 0) return img;
  if (h == INT32_MIN) return img;  // |h| overflows
  const bool bottom_up = h > 0;
  const int ah = std::abs(h);
  const int src_c = bpp / 8;
  const size_t row_stride = ((static_cast<size_t>(w) * src_c + 3) / 4) * 4;
  if (row_stride > (SIZE_MAX - data_off) / static_cast<size_t>(ah)) return img;
  if (b.size() < data_off + row_stride * ah) return img;
  img.w = w;
  img.h = ah;
  img.c = 3;
  img.data.resize(static_cast<size_t>(w) * ah * 3);
  for (int y = 0; y < ah; ++y) {
    const int src_y = bottom_up ? (ah - 1 - y) : y;
    const uint8_t* row =
        reinterpret_cast<const uint8_t*>(b.data()) + data_off + row_stride * src_y;
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = row + static_cast<size_t>(x) * src_c;
      uint8_t* dst = img.data.data() + (static_cast<size_t>(y) * w + x) * 3;
      dst[0] = px[2];  // BGR(A) -> RGB
      dst[1] = px[1];
      dst[2] = px[0];
    }
  }
  img.ok = true;
  return img;
}

// Raw RGB8 blob after an 8-byte header: uint32 h, uint32 w, little-endian.
Image DecodeRaw(const std::string& b) {
  Image img;
  if (b.size() < 8) return img;
  uint32_t h, w;
  std::memcpy(&h, b.data(), 4);
  std::memcpy(&w, b.data() + 4, 4);
  if (h == 0 || w == 0 || h > INT_MAX || w > INT_MAX) return img;
  if (static_cast<size_t>(h) > SIZE_MAX / 3 / w) return img;
  const size_t need = static_cast<size_t>(h) * w * 3;
  if (b.size() - 8 < need) return img;
  img.h = static_cast<int>(h);
  img.w = static_cast<int>(w);
  img.c = 3;
  img.data.assign(b.begin() + 8, b.begin() + 8 + need);
  img.ok = true;
  return img;
}

// By the magic bytes; a file with neither magic is a raw blob only when its
// path ends in ".raw".
Image DecodeFile(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return {};
  const std::string bytes((std::istreambuf_iterator<char>(f)),
                          std::istreambuf_iterator<char>());
  if (bytes.size() >= 2 && bytes[0] == 'P') return DecodePNM(bytes);
  if (bytes.size() >= 2 && bytes[0] == 'B' && bytes[1] == 'M') return DecodeBMP(bytes);
  const std::string p(path);
  const auto dot = p.rfind('.');
  if (dot != std::string::npos && p.substr(dot) == ".raw") return DecodeRaw(bytes);
  return {};
}

// Half-pixel bilinear (align_corners false, no antialiasing: the reference's
// keras/TF resize), then times the f32 reciprocal of 255. A grey source is
// replicated to three channels.
void ResizeNormalize(const Image& src, int out_h, int out_w, float* dst) {
  const float sy = static_cast<float>(src.h) / out_h;
  const float sx = static_cast<float>(src.w) / out_w;
  constexpr float kInv255 = 1.0f / 255.0f;
  for (int y = 0; y < out_h; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    const int y0 = std::clamp(static_cast<int>(std::floor(fy)), 0, src.h - 1);
    const int y1 = std::min(y0 + 1, src.h - 1);
    const float wy = std::clamp(fy - y0, 0.0f, 1.0f);
    for (int x = 0; x < out_w; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      const int x0 = std::clamp(static_cast<int>(std::floor(fx)), 0, src.w - 1);
      const int x1 = std::min(x0 + 1, src.w - 1);
      const float wx = std::clamp(fx - x0, 0.0f, 1.0f);
      for (int ch = 0; ch < 3; ++ch) {
        const int sc = src.c == 1 ? 0 : ch;
        const float a = src.data[(static_cast<size_t>(y0) * src.w + x0) * src.c + sc];
        const float b = src.data[(static_cast<size_t>(y0) * src.w + x1) * src.c + sc];
        const float c = src.data[(static_cast<size_t>(y1) * src.w + x0) * src.c + sc];
        const float d = src.data[(static_cast<size_t>(y1) * src.w + x1) * src.c + sc];
        const float top = a + (b - a) * wx;
        const float bot = c + (d - c) * wx;
        dst[(static_cast<size_t>(y) * out_w + x) * 3 + ch] = (top + (bot - top) * wy) * kInv255;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode n files into the caller's (n, out_h, out_w, 3) float32 buffer on up
// to num_threads threads, which claim files from an atomic counter. A file
// that does not decode leaves its slot zero and status[i] 0; status[i] is 1
// otherwise. Returns the number decoded.
int shm_decode_batch(const char** paths, int n, int out_h, int out_w, float* out,
                     uint8_t* status, int num_threads) {
  std::atomic<int> next(0), ok_count(0);
  const int workers = std::max(1, std::min(num_threads, n));
  const size_t plane = static_cast<size_t>(out_h) * out_w * 3;
  auto work = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const Image img = DecodeFile(paths[i]);
      float* dst = out + static_cast<size_t>(i) * plane;
      if (img.ok) {
        ResizeNormalize(img, out_h, out_w, dst);
        status[i] = 1;
        ok_count.fetch_add(1);
      } else {
        std::memset(dst, 0, sizeof(float) * plane);
        status[i] = 0;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return ok_count.load();
}

// Resize and scale one decoded (h, w, c) uint8 image, c 1 or at least 3
// (channels past the third are ignored), into (out_h, out_w, 3) float32.
void shm_resize_normalize(const uint8_t* data, int h, int w, int c, int out_h, int out_w,
                          float* out) {
  Image img;
  img.h = h;
  img.w = w;
  img.c = c;
  img.data.assign(data, data + static_cast<size_t>(h) * w * c);
  img.ok = true;
  ResizeNormalize(img, out_h, out_w, out);
}

// The channel-wise minimum over v aligned images of `size` floats each,
// (v, size) -> (size): the pseudo-diffuse estimate of a polarisation stack.
void shm_estimate_diffuse(const float* views, int v, int64_t size, float* out) {
  std::memcpy(out, views, sizeof(float) * size);
  for (int i = 1; i < v; ++i) {
    const float* src = views + static_cast<int64_t>(i) * size;
    for (int64_t j = 0; j < size; ++j) out[j] = std::min(out[j], src[j]);
  }
}

}  // extern "C"
