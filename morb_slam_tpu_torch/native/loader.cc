// Prefetching image loader of the PyTorch port: the only image reader on a
// machine without OpenCV (the port's copy of the reference package's
// native/loader.cc; same C interface, same decoding).
//
// A worker pool decodes PNG (8/16-bit grey, grey+alpha, RGB, RGBA; not
// interlaced; zlib inflate + unfilter) and binary PGM / PPM frames ahead of
// the consumer into a bounded ring of float32 grey images (0..255, BT.601
// luma for colour), so the feed loop overlaps file reads and decoding with
// the card's work.
//
// C interface (ctypes):
//   void* loader_create(const char** paths, int n, int n_workers,
//                       int prefetch, int* out_w, int* out_h);
//   int   loader_next(void* h, float* dst, int capacity);  // -> frame idx
//   void  loader_destroy(void* h);
//   int   decode_image(const char* path, float* dst, int capacity,
//                      int* w, int* h);                    // one image
//
// Build (io/native_loader.py does it at first use):
//   g++ -O3 -march=native -std=c++17 -shared -fPIC loader.cc -lz -lpthread
#include <zlib.h>

#include <cctype>
#include <cstdlib>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal image decoding (8/16-bit grayscale + RGB(A) PNG, non-interlaced;
// binary PGM/PPM). Output: float32 grayscale, values 0..255.
// ---------------------------------------------------------------------------

struct Image {
  int w = 0, h = 0;
  std::vector<float> px;
  bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
      pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  bool ok = fread(out->data(), 1, n, f) == size_t(n);
  fclose(f);
  return ok;
}

Image decode_png(const std::vector<uint8_t>& buf) {
  Image im;
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || memcmp(buf.data(), magic, 8) != 0) return im;
  size_t pos = 8;
  int w = 0, h = 0, bit_depth = 0, color = -1, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= buf.size()) {
    uint32_t len = rd_u32(&buf[pos]);
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (pos + 12 + len > buf.size()) break;
    if (!memcmp(type, "IHDR", 4)) {
      w = rd_u32(data);
      h = rd_u32(data + 4);
      bit_depth = data[8];
      color = data[9];
      interlace = data[12];
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  // supported: gray(0), rgb(2), gray+alpha(4), rgba(6); 8/16-bit; progressive
  // (Adam7) not supported
  if (w <= 0 || h <= 0 || interlace != 0) return im;
  if (color != 0 && color != 2 && color != 4 && color != 6) return im;
  if (bit_depth != 8 && bit_depth != 16) return im;
  int ch = (color == 0) ? 1 : (color == 2) ? 3 : (color == 4) ? 2 : 4;
  int bpp = ch * bit_depth / 8;               // bytes per pixel
  size_t stride = size_t(w) * bpp;
  std::vector<uint8_t> raw((stride + 1) * h);
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return im;
  zs.next_in = idat.data();
  zs.avail_in = idat.size();
  zs.next_out = raw.data();
  zs.avail_out = raw.size();
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zret != Z_STREAM_END && zret != Z_OK) return im;

  // unfilter in place into `img`
  std::vector<uint8_t> img(stride * h);
  for (int y = 0; y < h; y++) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &img[stride * y];
    const uint8_t* up = y ? &img[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return im;
      }
      dst[x] = uint8_t(v);
    }
  }

  im.w = w;
  im.h = h;
  im.px.resize(size_t(w) * h);
  int step = bit_depth / 8;
  for (size_t i = 0; i < size_t(w) * h; i++) {
    const uint8_t* p = &img[i * bpp];
    float v;
    if (ch >= 3) {                           // BT.601 luma like cv::imread
      float r = p[0 * step], g = p[1 * step], b = p[2 * step];
      if (bit_depth == 16) {
        r = (p[0] * 256 + p[1]) / 257.0f;
        g = (p[2] * 256 + p[3]) / 257.0f;
        b = (p[4] * 256 + p[5]) / 257.0f;
      }
      v = 0.299f * r + 0.587f * g + 0.114f * b;
    } else {
      v = bit_depth == 16 ? (p[0] * 256 + p[1]) / 257.0f : float(p[0]);
    }
    im.px[i] = v;
  }
  im.ok = true;
  return im;
}

Image decode_pnm(const std::vector<uint8_t>& buf) {
  Image im;
  if (buf.size() < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6'))
    return im;
  int ch = buf[1] == '5' ? 1 : 3;
  size_t pos = 2;
  int vals[3], got = 0;
  while (got < 3 && pos < buf.size()) {
    while (pos < buf.size() && (isspace(buf[pos]) || buf[pos] == '#')) {
      if (buf[pos] == '#')
        while (pos < buf.size() && buf[pos] != '\n') pos++;
      else
        pos++;
    }
    int v = 0;
    while (pos < buf.size() && isdigit(buf[pos]))
      v = v * 10 + (buf[pos++] - '0');
    vals[got++] = v;
  }
  pos++;  // single whitespace after maxval
  if (got < 3) return im;
  int w = vals[0], h = vals[1], maxv = vals[2];
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 65535) return im;
  int step = maxv > 255 ? 2 : 1;
  if (pos + size_t(w) * h * ch * step > buf.size()) return im;
  im.w = w;
  im.h = h;
  im.px.resize(size_t(w) * h);
  const uint8_t* p = &buf[pos];
  for (size_t i = 0; i < size_t(w) * h; i++) {
    float v;
    if (ch == 3) {
      float r = p[0], g = p[step], b = p[2 * step];
      v = 0.299f * r + 0.587f * g + 0.114f * b;
    } else {
      v = step == 2 ? (p[0] * 256 + p[1]) * 255.0f / maxv : float(p[0]);
    }
    im.px[i] = v;
    p += ch * step;
  }
  im.ok = true;
  return im;
}

Image decode_any(const char* path) {
  std::vector<uint8_t> buf;
  Image im;
  if (!read_file(path, &buf)) return im;
  im = decode_png(buf);
  if (!im.ok) im = decode_pnm(buf);
  return im;
}

// ---------------------------------------------------------------------------
// Prefetching loader: worker pool + in-order bounded hand-off
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  int prefetch;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<Image> slots;        // decoded frames, indexed by frame id
  std::vector<uint8_t> done;       // 1 when slots[i] ready
  std::atomic<int> next_fetch{0};  // next frame id to decode
  int next_emit = 0;               // next frame id the consumer takes
  bool stop = false;

  void work() {
    for (;;) {
      int i = next_fetch.fetch_add(1);
      if (i >= int(paths.size())) return;
      {
        // bound how far ahead of the consumer we run
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stop || i < next_emit + prefetch; });
        if (stop) return;
      }
      Image im = decode_any(paths[i].c_str());
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[i] = std::move(im);
        done[i] = 1;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n, int n_workers, int prefetch,
                    int* out_w, int* out_h) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->prefetch = prefetch < 2 ? 2 : prefetch;
  L->slots.resize(n);
  L->done.assign(n, 0);
  if (n > 0) {
    Image first = decode_any(L->paths[0].c_str());
    if (out_w) *out_w = first.w;
    if (out_h) *out_h = first.h;
    L->slots[0] = std::move(first);
    L->done[0] = 1;
    L->next_fetch = 1;
  }
  int nw = n_workers < 1 ? 1 : n_workers;
  for (int i = 0; i < nw; i++) L->workers.emplace_back(&Loader::work, L);
  return L;
}

// Copies the next frame (in feed order) into dst; returns the frame index,
// -1 at end of sequence, -2 on decode failure, -3 if dst too small.
int loader_next(void* h, float* dst, int capacity) {
  auto* L = static_cast<Loader*>(h);
  int i;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->next_emit >= int(L->paths.size())) return -1;
    i = L->next_emit;
    L->cv_ready.wait(lk, [&] { return L->done[i] != 0; });
  }
  Image& im = L->slots[i];
  int ret = i;
  if (!im.ok)
    ret = -2;
  else if (int64_t(im.w) * im.h > capacity)
    ret = -3;
  else
    memcpy(dst, im.px.data(), sizeof(float) * im.px.size());
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->slots[i] = Image();  // free the buffer
    L->next_emit = i + 1;
  }
  L->cv_space.notify_all();
  return ret;
}

void loader_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->next_fetch = int(L->paths.size());
  }
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

int decode_image(const char* path, float* dst, int capacity, int* w,
                 int* h) {
  Image im = decode_any(path);
  if (!im.ok) return -2;
  if (w) *w = im.w;
  if (h) *h = im.h;
  if (int64_t(im.w) * im.h > capacity) return -3;
  memcpy(dst, im.px.data(), sizeof(float) * im.px.size());
  return 0;
}

}  // extern "C"
