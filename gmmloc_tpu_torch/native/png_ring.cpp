// The port's PNG decoder and stereo prefetch ring (host C++, zlib only).
//
// The JAX package decodes through libpng (native/euroc_loader.cpp). The
// machines with the card have zlib but no libpng headers, so the port
// carries one decoder of its own, used on every machine: PNG chunks are
// read here, the image data inflated with zlib and un-filtered (None,
// Sub, Up, Average, Paeth), and the pixels converted to 8-bit gray
// exactly as that loader's libpng set-up converts them
// (euroc_loader.cpp:54-64):
//   - 16-bit samples keep their high byte (png_set_strip_16), after the
//     gray conversion;
//   - an alpha channel is dropped (png_set_strip_alpha);
//   - RGB becomes gray by png_set_rgb_to_gray_fixed(png, 1, -1, -1) with
//     no gAMA, sRGB, iCCP or cHRM chunk: libpng's default coefficients
//     (6968, 23434, 2366) / 32768, truncated at 8 bits where the channels
//     differ, rounded at 16 bits.
// Palette images, gray below 8 bits, interlaced images and colour images
// that carry colour-space chunks are refused (rc -6): their libpng
// conversions are not reproduced. EuRoC's images are 8-bit gray.
//
// The ring is native/euroc_loader.cpp's (ref dataloader.cpp:53-116 and
// the decode threads of gmmloc.cpp:241-249): workers claim frames in
// order and decode into slot f % capacity, each slot served to frames in
// strict turn, and the consumer takes frames in order.
//
// Build (utils/native.py, at first use):
//   g++ -O3 -fPIC -shared -std=c++17 png_ring.cpp -o libpng_ring_<hash>.so -lz -lpthread

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  uint8_t tmp[65536];
  size_t n;
  while ((n = std::fread(tmp, 1, sizeof tmp, fp)) > 0) buf->insert(buf->end(), tmp, tmp + n);
  std::fclose(fp);
  return true;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Decode one PNG to 8-bit gray. Returns 0 on success; -1 the file cannot
// be opened, -2 not a PNG, -4 corrupt (a chunk, its CRC, the zlib stream,
// a filter type), -5 larger than `cap` pixels, -6 a format the decoder
// refuses (see the file comment).
int decode_gray(const char* path, uint8_t* out, int64_t cap, int32_t* out_w,
                int32_t* out_h) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  if (buf.size() < 8 || std::memcmp(buf.data(), kSig, 8) != 0) return -2;
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  bool colorspace = false, have_ihdr = false, have_iend = false;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= buf.size() && !have_iend) {
    uint32_t len = be32(&buf[pos]);
    if (len > buf.size() - pos - 12) return -4;
    const uint8_t* type = &buf[pos + 4];
    const uint8_t* data = type + 4;
    bool critical = !(type[0] & 0x20);
    if (critical &&
        uint32_t(crc32(0, type, len + 4)) != be32(data + len)) return -4;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return -4;
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      color = data[9];
      interlace = data[12];
      have_ihdr = true;
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      have_iend = true;
    } else if (!std::memcmp(type, "gAMA", 4) || !std::memcmp(type, "sRGB", 4) ||
               !std::memcmp(type, "iCCP", 4) || !std::memcmp(type, "cHRM", 4)) {
      colorspace = true;
    }
    pos += 12 + size_t(len);
  }
  if (!have_ihdr || idat.empty() || w == 0 || h == 0) return -4;
  int channels;
  switch (color) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return -6;                      // palette, or not a colour type
  }
  if ((depth != 8 && depth != 16) || interlace != 0) return -6;
  if (channels >= 3 && colorspace) return -6;
  if (int64_t(w) * h > cap) return -5;

  const size_t bpp = size_t(channels) * (depth / 8);
  const size_t row = bpp * w;
  std::vector<uint8_t> raw((row + 1) * h);
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) return -4;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zr = inflate(&zs, Z_FINISH);
  size_t got = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if (got != raw.size() || (zr != Z_STREAM_END && zr != Z_OK && zr != Z_BUF_ERROR))
    return -4;

  // un-filter in place: row y's bytes follow its filter type byte
  std::vector<uint8_t> prev(row, 0);
  const uint32_t rc = 6968, gc = 23434, bc = 32768 - rc - gc;
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* r = &raw[y * (row + 1) + 1];
    const uint8_t* b = prev.data();
    switch (r[-1]) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < row; ++i) r[i] = uint8_t(r[i] + r[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < row; ++i) r[i] = uint8_t(r[i] + b[i]);
        break;
      case 3:
        for (size_t i = 0; i < bpp; ++i) r[i] = uint8_t(r[i] + (b[i] >> 1));
        for (size_t i = bpp; i < row; ++i) r[i] = uint8_t(r[i] + ((r[i - bpp] + b[i]) >> 1));
        break;
      case 4:
        for (size_t i = 0; i < bpp; ++i) r[i] = uint8_t(r[i] + b[i]);
        for (size_t i = bpp; i < row; ++i)
          r[i] = uint8_t(r[i] + paeth(r[i - bpp], b[i], b[i - bpp]));
        break;
      default:
        return -4;
    }
    std::memcpy(prev.data(), r, row);
    uint8_t* o = out + size_t(y) * w;
    if (channels == 1 && depth == 8) {
      std::memcpy(o, r, w);
      continue;
    }
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t* px = r + x * bpp;
      if (channels <= 2) {
        o[x] = px[0];                        // gray (or its high byte)
      } else if (depth == 8) {
        uint32_t R = px[0], G = px[1], B = px[2];
        o[x] = (R == G && R == B) ? uint8_t(R) : uint8_t((rc * R + gc * G + bc * B) >> 15);
      } else {
        uint32_t R = (px[0] << 8) | px[1], G = (px[2] << 8) | px[3], B = (px[4] << 8) | px[5];
        o[x] = uint8_t(((rc * R + gc * G + bc * B + 16384) >> 15) >> 8);
      }
    }
  }
  *out_w = int32_t(w);
  *out_h = int32_t(h);
  return 0;
}

struct Ring {
  std::vector<std::string> left, right;
  int64_t slot_cap;  // pixels per image slot
  int capacity;
  std::vector<uint8_t> buf_l, buf_r;
  std::vector<int32_t> dims;        // (capacity, 4): wl, hl, wr, hr
  std::vector<int> status;          // per slot: -1 not ready, 0 ok, else the error
  std::vector<int64_t> slot_turn;   // the next frame allowed to use the slot
  std::atomic<int64_t> next_claim{0};
  int64_t next_consume = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  Ring(std::vector<std::string> l, std::vector<std::string> r, int64_t cap, int capacity_,
       int n_threads)
      : left(std::move(l)), right(std::move(r)), slot_cap(cap), capacity(capacity_),
        buf_l(size_t(capacity_) * cap), buf_r(size_t(capacity_) * cap),
        dims(size_t(capacity_) * 4), status(capacity_, -1), slot_turn(capacity_) {
    for (int i = 0; i < capacity_; ++i) slot_turn[i] = i;
    for (int i = 0; i < n_threads; ++i) workers.emplace_back([this] { work(); });
  }

  ~Ring() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
  }

  void work() {
    const int64_t n = int64_t(left.size());
    while (!stop.load()) {
      int64_t f = next_claim.fetch_add(1);
      if (f >= n) return;
      int slot = int(f % capacity);
      {
        // this frame's turn on the slot: its previous frame was decoded
        // and consumed
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || slot_turn[slot] == f; });
        if (stop.load()) return;
      }
      int32_t wl = 0, hl = 0, wr = 0, hr = 0;
      int rc1 = decode_gray(left[f].c_str(), buf_l.data() + slot * slot_cap, slot_cap, &wl, &hl);
      int rc2 = decode_gray(right[f].c_str(), buf_r.data() + slot * slot_cap, slot_cap, &wr, &hr);
      {
        std::lock_guard<std::mutex> lk(mu);
        int32_t* d = &dims[slot * 4];
        d[0] = wl, d[1] = hl, d[2] = wr, d[3] = hr;
        status[slot] = rc1 != 0 ? -rc1 : -rc2;   // > 0: the failing decode's code
      }
      cv_ready.notify_all();
    }
  }

  // Blocking in-order take: 0 ok, > 0 a decode error, -1 exhausted.
  int take(uint8_t* out_l, uint8_t* out_r, int32_t* whwh) {
    const int64_t n = int64_t(left.size());
    if (next_consume >= n) return -1;
    int64_t f = next_consume++;
    int slot = int(f % capacity);
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] { return stop.load() || (slot_turn[slot] == f && status[slot] != -1); });
    if (stop.load()) return -2;
    int rc = status[slot];
    std::memcpy(whwh, &dims[slot * 4], 4 * sizeof(int32_t));
    if (rc == 0) {
      std::memcpy(out_l, buf_l.data() + slot * slot_cap, int64_t(whwh[0]) * whwh[1]);
      std::memcpy(out_r, buf_r.data() + slot * slot_cap, int64_t(whwh[2]) * whwh[3]);
    }
    status[slot] = -1;
    slot_turn[slot] = f + capacity;
    lk.unlock();
    cv_free.notify_all();
    return rc;
  }
};

std::vector<std::string> split_lines(const char* joined) {
  std::vector<std::string> out;
  const char* p = joined;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    if (!nl) {
      out.emplace_back(p);
      break;
    }
    out.emplace_back(p, nl - p);
    p = nl + 1;
  }
  return out;
}

}  // namespace

extern "C" {

int gmmloc_png_decode_gray(const char* path, uint8_t* out, int64_t cap, int32_t* w,
                           int32_t* h) {
  return decode_gray(path, out, cap, w, h);
}

void* gmmloc_png_ring_create(const char* left_joined, const char* right_joined,
                             int64_t slot_cap, int capacity, int n_threads) {
  auto l = split_lines(left_joined);
  auto r = split_lines(right_joined);
  if (l.size() != r.size() || l.empty() || capacity < 1 || n_threads < 1) return nullptr;
  return new Ring(std::move(l), std::move(r), slot_cap, capacity, n_threads);
}

int gmmloc_png_ring_take(void* ring, uint8_t* out_l, uint8_t* out_r, int32_t* whwh) {
  return static_cast<Ring*>(ring)->take(out_l, out_r, whwh);
}

void gmmloc_png_ring_destroy(void* ring) { delete static_cast<Ring*>(ring); }

const char* gmmloc_png_zlib_version() { return zlibVersion(); }

}  // extern "C"
