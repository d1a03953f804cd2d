// The port's threaded PNG decoder (its own copy of the JAX package's
// native/loader.cpp), loaded by fcvsr_tpu_torch/data/native_loader.py.
//
// The reference decodes whole datasets of PNG frames at startup in Python
// DataLoader workers (the CVCP cache alone decodes thousands).  This is a
// dependency-free PNG decoder (zlib inflate + per-row unfiltering) with a
// std::thread batch front-end and a uint8 -> float32 [0,1] converter,
// exposed through a C ABI for ctypes.  Non-interlaced 8-bit gray /
// gray+alpha / RGB / RGBA PNGs (the formats the reference datasets use).
//
// Built at first use by native_loader.py:
//   g++ -O3 -fPIC -shared -std=c++17 loader.cpp -lz -lpthread
// into fcvsr_tpu_torch/_build/host/.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kPngMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

struct PngHeader {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  int channels = 0;
};

// Parse chunks; returns 0 on success. idat accumulates compressed data.
int parse_png(const uint8_t* buf, size_t len, PngHeader* hdr,
              std::vector<uint8_t>* idat) {
  if (len < 8 || std::memcmp(buf, kPngMagic, 8) != 0) return -1;
  size_t pos = 8;
  while (pos + 8 <= len) {
    uint32_t clen = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (pos + 12 + clen > len) return -2;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (clen < 13) return -3;
      hdr->width = be32(data);
      hdr->height = be32(data + 4);
      hdr->bit_depth = data[8];
      hdr->color_type = data[9];
      hdr->interlace = data[12];
      switch (hdr->color_type) {
        case 0: hdr->channels = 1; break;
        case 2: hdr->channels = 3; break;
        case 4: hdr->channels = 2; break;
        case 6: hdr->channels = 4; break;
        default: return -4;  // palette unsupported
      }
      if (hdr->bit_depth != 8 || hdr->interlace != 0) return -5;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), data, data + clen);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + clen;
  }
  return (hdr->width && hdr->height && !idat->empty()) ? 0 : -6;
}

int inflate_idat(const std::vector<uint8_t>& idat, uint8_t* out,
                 size_t out_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -1;
  zs.next_in = const_cast<uint8_t*>(idat.data());
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = out;
  zs.avail_out = static_cast<uInt>(out_len);
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return (ret == Z_STREAM_END && zs.avail_out == 0) ? 0 : -2;
}

void unfilter(uint8_t* raw, uint8_t* out, uint32_t h, size_t stride, int bpp) {
  // per-row specialised loops: the filter byte is constant within a row, so
  // hoisting the switch lets the compiler vectorise None/Up and keep
  // Sub/Avg/Paeth dependency chains tight.
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = raw + y * (stride + 1) + 1;
    uint8_t* dst = out + y * stride;
    const uint8_t* prev = y ? out + (y - 1) * stride : nullptr;
    size_t ubpp = size_t(bpp);
    switch (filter) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (size_t x = 0; x < ubpp && x < stride; ++x) dst[x] = src[x];
        for (size_t x = ubpp; x < stride; ++x)
          dst[x] = uint8_t(src[x] + dst[x - ubpp]);
        break;
      case 2:
        if (prev) {
          for (size_t x = 0; x < stride; ++x)
            dst[x] = uint8_t(src[x] + prev[x]);
        } else {
          std::memcpy(dst, src, stride);
        }
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= ubpp ? dst[x - ubpp] : 0;
          int b = prev ? prev[x] : 0;
          dst[x] = uint8_t(src[x] + (a + b) / 2);
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= ubpp ? dst[x - ubpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= ubpp) ? prev[x - ubpp] : 0;
          dst[x] = uint8_t(src[x] + paeth(a, b, c));
        }
        break;
    }
  }
}

// Decode a whole file into caller-provided scratch. Returns 0 on success.
// expected_w/expected_h (>0) bound the caller's buffer: dimensions are
// validated right after the header parse, BEFORE any pixel is written, so an
// oversized file can never overflow a fixed-size batch slot. Pass -1 to skip.
int decode_file(const char* path, uint8_t* out, int out_channels,
                int* width, int* height,
                int expected_w = -1, int expected_h = -1) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -10;
  std::fseek(f, 0, SEEK_END);
  long flen = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(flen);
  size_t rd = std::fread(buf.data(), 1, flen, f);
  std::fclose(f);
  if (rd != size_t(flen)) return -11;

  PngHeader hdr;
  std::vector<uint8_t> idat;
  int rc = parse_png(buf.data(), buf.size(), &hdr, &idat);
  if (rc) return rc;
  *width = int(hdr.width);
  *height = int(hdr.height);
  if ((expected_w > 0 && int(hdr.width) != expected_w) ||
      (expected_h > 0 && int(hdr.height) != expected_h))
    return -30;  // size mismatch: refuse before touching the output buffer
  size_t stride = size_t(hdr.width) * hdr.channels;
  std::vector<uint8_t> raw((stride + 1) * hdr.height);
  rc = inflate_idat(idat, raw.data(), raw.size());
  if (rc) return rc - 20;
  std::vector<uint8_t> pix(stride * hdr.height);
  unfilter(raw.data(), pix.data(), hdr.height, stride, hdr.channels);

  size_t n = size_t(hdr.width) * hdr.height;
  // channel conversion into out (out_channels = 1 or 3), PIL semantics:
  // L = (R*299 + G*587 + B*114) / 1000  (exact integer arithmetic).
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* px = pix.data() + i * hdr.channels;
    uint8_t r, g, b;
    switch (hdr.channels) {
      case 1: r = g = b = px[0]; break;
      case 2: r = g = b = px[0]; break;           // gray+alpha: drop alpha
      case 3: r = px[0]; g = px[1]; b = px[2]; break;
      default: r = px[0]; g = px[1]; b = px[2]; break;  // RGBA: drop alpha
    }
    if (out_channels == 1) {
      // PIL's exact fixed-point ITU-R 601-2 luma
      out[i] = uint8_t((19595u * r + 38470u * g + 7471u * b + 0x8000u) >> 16);
    } else {
      out[i * 3 + 0] = r;
      out[i * 3 + 1] = g;
      out[i * 3 + 2] = b;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Probe dimensions without decoding pixels. Returns 0 on success.
int fcvsr_png_info(const char* path, int* width, int* height, int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -10;
  uint8_t head[4096];
  size_t rd = std::fread(head, 1, sizeof(head), f);
  std::fclose(f);
  PngHeader hdr;
  std::vector<uint8_t> idat;
  // parse only as far as IHDR; parse_png tolerates truncated IDAT
  if (rd < 33 || std::memcmp(head, kPngMagic, 8) != 0) return -1;
  if (std::memcmp(head + 12, "IHDR", 4) != 0) return -3;
  hdr.width = be32(head + 16);
  hdr.height = be32(head + 20);
  hdr.bit_depth = head[24];
  hdr.color_type = head[25];
  *width = int(hdr.width);
  *height = int(hdr.height);
  switch (hdr.color_type) {
    case 0: case 4: *channels = 1; break;
    case 2: case 6: *channels = 3; break;
    default: return -4;
  }
  return hdr.bit_depth == 8 ? 0 : -5;
}

// Decode one PNG into out (H*W*out_channels bytes). Returns 0 on success.
int fcvsr_png_decode(const char* path, uint8_t* out, int out_channels,
                     int* width, int* height) {
  return decode_file(path, out, out_channels, width, height);
}

// Decode a batch of equally-sized PNGs with a thread pool.
// paths: array of n C strings; out: n * h * w * channels bytes.
// Returns 0 if every file decoded, else the first non-zero status.
int fcvsr_png_decode_batch(const char** paths, int n, uint8_t* out,
                           int out_channels, int frame_h, int frame_w,
                           int num_threads) {
  std::vector<int> status(n, 0);
  size_t frame_bytes = size_t(frame_h) * frame_w * out_channels;
  int workers = num_threads > 0 ? num_threads : 4;
  std::vector<std::thread> pool;
  std::atomic<int> next(0);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        int w = 0, h = 0;
        status[i] = decode_file(paths[i], out + size_t(i) * frame_bytes,
                                out_channels, &w, &h, frame_w, frame_h);
      }
    });
  }
  for (auto& th : pool) th.join();
  for (int s : status)
    if (s) return s;
  return 0;
}

// uint8 -> float32 in [0,1], vectorized by the compiler.
void fcvsr_u8_to_f32(const uint8_t* in, float* out, int64_t n) {
  constexpr float kScale = 1.0f / 255.0f;
  for (int64_t i = 0; i < n; ++i) out[i] = in[i] * kScale;
}

}  // extern "C"
