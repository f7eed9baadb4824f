// Threaded PNG batch codec for the measure's image dumps and read-backs
// (the port's copy of baddiffusion_tpu/native/pngio.cpp; the same encoder,
// so the same bytes for the same image).
//
// A measure writes and reads back thousands of PNGs (2048 real + 2048 clean
// + 2048 backdoor images in the reference's recipe). This codec encodes and
// decodes whole batches on a pool of threads: a minimal PNG implementation
// on zlib's DEFLATE, filters 0-4 on decode and filter 0 on encode (level 1:
// the files are throwaway evaluation artifacts, so throughput over size).
//
// A plain C interface, bound with ctypes (baddiffusion_tpu_torch/native/pngio.py):
//   encode_png_batch(imgs NHWC u8, n,h,w,c, paths, n_threads) -> 0 | -index-1
//   decode_png_batch(paths, n, out NHWC u8, h,w,c, n_threads) -> 0 | -index-1
//   png_read_header(path, &w,&h,&c) -> 0 on success

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t crc_table[256];
bool crc_ready = false;

void init_crc() {
  if (crc_ready) return;
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t v = n;
    for (int k = 0; k < 8; k++) v = (v & 1) ? 0xedb88320u ^ (v >> 1) : v >> 1;
    crc_table[n] = v;
  }
  crc_ready = true;
}

uint32_t crc_raw(uint32_t c, const uint8_t* buf, size_t len) {
  for (size_t i = 0; i < len; i++) c = crc_table[(c ^ buf[i]) & 0xff] ^ (c >> 8);
  return c;
}

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

uint32_t get_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

bool write_chunk(FILE* f, const char type[4], const uint8_t* data, uint32_t len) {
  uint8_t head[8];
  put_be32(head, len);
  memcpy(head + 4, type, 4);
  if (fwrite(head, 1, 8, f) != 8) return false;
  if (len && fwrite(data, 1, len, f) != len) return false;
  uint32_t crc = 0xffffffffu;
  crc = crc_raw(crc, head + 4, 4);
  if (len) crc = crc_raw(crc, data, len);
  crc ^= 0xffffffffu;
  uint8_t tail[4];
  put_be32(tail, crc);
  return fwrite(tail, 1, 4, f) == 4;
}

bool encode_one(const uint8_t* img, int h, int w, int c, const char* path) {
  if (c != 1 && c != 3) return false;
  init_crc();
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  bool ok = fwrite(kSig, 1, 8, f) == 8;

  uint8_t ihdr[13];
  put_be32(ihdr, (uint32_t)w);
  put_be32(ihdr + 4, (uint32_t)h);
  ihdr[8] = 8;                       // bit depth
  ihdr[9] = (c == 1) ? 0 : 2;        // grayscale / truecolor
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  ok = ok && write_chunk(f, "IHDR", ihdr, 13);

  // raw scanlines with filter byte 0
  const size_t stride = (size_t)w * c;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; y++) {
    raw[(stride + 1) * y] = 0;
    memcpy(&raw[(stride + 1) * y + 1], img + stride * y, stride);
  }
  uLongf bound = compressBound(raw.size());
  std::vector<uint8_t> comp(bound);
  // level 1: eval artifacts are throwaway; throughput over ratio
  if (compress2(comp.data(), &bound, raw.data(), raw.size(), 1) != Z_OK) ok = false;
  ok = ok && write_chunk(f, "IDAT", comp.data(), (uint32_t)bound);
  ok = ok && write_chunk(f, "IEND", nullptr, 0);
  fclose(f);
  return ok;
}

int paeth(int a, int b, int cc) {
  int p = a + b - cc, pa = abs(p - a), pb = abs(p - b), pc = abs(p - cc);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return cc;
}

// decode into out (h*w*c, already-known geometry); src channels converted to
// the requested c (gray<->rgb) if they differ
bool decode_one(const char* path, uint8_t* out, int oh, int ow, int oc) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz < 8) {  // no signature, or ftell failed
    fclose(f);
    return false;
  }
  std::vector<uint8_t> buf(sz);
  bool ok = fread(buf.data(), 1, sz, f) == (size_t)sz;
  fclose(f);
  if (!ok || sz < 8 || memcmp(buf.data(), kSig, 8) != 0) return false;

  int w = 0, h = 0, channels = 0, bit_depth = 0, interlace = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= (size_t)sz) {
    uint32_t len = get_be32(&buf[pos]);
    // a truncated/corrupt file can declare any 32-bit length — the chunk
    // payload + CRC must actually fit in the buffer before data is touched,
    // or idat.insert reads past the heap allocation
    if (len > (size_t)sz - pos - 12) return false;
    const char* type = (const char*)&buf[pos + 4];
    const uint8_t* data = &buf[pos + 8];
    if (!memcmp(type, "IHDR", 4)) {
      if (len < 13) return false;
      w = get_be32(data);
      h = get_be32(data + 4);
      bit_depth = data[8];
      int ct = data[9];
      interlace = data[12];
      channels = (ct == 0) ? 1 : (ct == 2) ? 3 : (ct == 4) ? 2 : (ct == 6) ? 4 : -1;
      if (channels < 0 || bit_depth != 8 || interlace != 0) return false;
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (w != ow || h != oh || w <= 0 || h <= 0 || channels <= 0) return false;

  const size_t stride = (size_t)w * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf rawlen = raw.size();
  if (uncompress(raw.data(), &rawlen, idat.data(), idat.size()) != Z_OK) return false;
  if (rawlen != raw.size()) return false;  // short stream = truncated image data

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (int y = 0; y < h; y++) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* line = &raw[(stride + 1) * y + 1];
    for (size_t x = 0; x < stride; x++) {
      int a = x >= (size_t)channels ? cur[x - channels] : 0;
      int b = prev[x];
      int cc = x >= (size_t)channels ? prev[x - channels] : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, cc); break;
        default: return false;
      }
      cur[x] = (uint8_t)v;
    }
    // channel conversion into out
    uint8_t* orow = out + (size_t)y * ow * oc;
    for (int x = 0; x < w; x++) {
      const uint8_t* px = &cur[(size_t)x * channels];
      if (oc == channels || (oc < channels && channels - oc == 1)) {
        for (int k = 0; k < oc; k++) orow[x * oc + k] = px[k];  // drops alpha if present
      } else if (oc == 1) {
        // luminance (BT.601 integer approx)
        orow[x] = (uint8_t)((299 * px[0] + 587 * px[1] + 114 * px[2]) / 1000);
      } else if (oc == 3 && channels <= 2) {
        orow[x * 3] = orow[x * 3 + 1] = orow[x * 3 + 2] = px[0];
      } else {
        for (int k = 0; k < oc; k++) orow[x * oc + k] = px[k < channels ? k : channels - 1];
      }
    }
    prev.swap(cur);
  }
  return true;
}

template <typename Fn>
int parallel_for(int n, int n_threads, Fn fn) {
  std::atomic<int> next(0), failed(-1);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (!fn(i)) {
        int expected = -1;
        failed.compare_exchange_strong(expected, i);
      }
    }
  };
  int t = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (t > n) t = n;
  if (t <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < t; i++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  int bad = failed.load();
  return bad < 0 ? 0 : -(bad + 1);
}

}  // namespace

extern "C" {

int encode_png_batch(const uint8_t* imgs, int n, int h, int w, int c,
                     const char** paths, int n_threads) {
  init_crc();  // before the pool: concurrent lazy init would be a data race
  const size_t per = (size_t)h * w * c;
  return parallel_for(n, n_threads, [&](int i) {
    return encode_one(imgs + per * i, h, w, c, paths[i]);
  });
}

int decode_png_batch(const char** paths, int n, uint8_t* out, int h, int w,
                     int c, int n_threads) {
  const size_t per = (size_t)h * w * c;
  return parallel_for(n, n_threads, [&](int i) {
    return decode_one(paths[i], out + per * i, h, w, c);
  });
}

int png_read_header(const char* path, int* w, int* h, int* c) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t head[33];
  bool ok = fread(head, 1, 33, f) == 33;
  fclose(f);
  if (!ok || memcmp(head, kSig, 8) != 0 || memcmp(head + 12, "IHDR", 4) != 0) return -1;
  *w = (int)get_be32(head + 16);
  *h = (int)get_be32(head + 20);
  int ct = head[25];
  *c = (ct == 0) ? 1 : (ct == 2) ? 3 : (ct == 4) ? 2 : (ct == 6) ? 4 : -1;
  return 0;
}

}  // extern "C"
