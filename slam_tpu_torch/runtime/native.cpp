// slam_tpu_torch native runtime: the host-side pieces around the card's
// compute path. The port's own copy of slam_tpu/runtime/native.cpp, with
// its own PNG decoder:
//
//   1. build_tracks  - the track-id chaining pass of the track store, the
//      one sequential step of the frontend's bookkeeping (reference
//      tracking_database.py:273-337);
//   2. PNG decode    - an 8-bit grayscale decoder on zlib alone (inflate,
//      the five row filters, CRC checks), into uint8 or float32 [0, 1],
//      edge-replicate-padded to a bucket shape when asked;
//   3. loader_*      - a background stereo-chunk prefetcher: worker
//      threads decode chunk c+1 while the caller uploads and computes
//      chunk c, and hand it over as uint8 (a quarter of float32's bytes
//      over the host-to-device link; the device converts).
//
// The decoder reads what KITTI ships (8-bit grayscale) and every other
// non-interlaced PNG of 8 bits or fewer per sample, and 16-bit grayscale;
// colour becomes gray by libpng's default fixed-point weights
// (png_set_rgb_to_gray_fixed(png, 1, -1, -1)), so it agrees with the JAX
// package's libpng decoder. Interlaced images and 16-bit colour are
// refused (return code 6). It needs no libpng, which the H100 machines
// lack. Built as a plain shared library (g++ -lz -pthread) and bound
// through ctypes.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         (uint32_t)p[3];
}

// libpng's default rgb-to-gray weights (BT.709 in 1/32768), truncated as
// libpng's non-gamma path does; equal channels pass through unchanged.
uint8_t rgb_gray(uint8_t r, uint8_t g, uint8_t b) {
  if (r == g && r == b) return r;
  return (uint8_t)((6968u * r + 23434u * g + 2366u * b) >> 15);
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// Return codes: 0 ok, 1 cannot open, 2 not a PNG, 3 corrupt (CRC, length,
// inflate, filter), 4 larger than the caller's buffer, 6 unsupported.
int decode_gray8(const char* path, std::vector<uint8_t>& img, uint32_t& W,
                 uint32_t& H) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  std::vector<uint8_t> file;
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof buf, fp)) > 0)
    file.insert(file.end(), buf, buf + got);
  fclose(fp);
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (file.size() < 8 || memcmp(file.data(), sig, 8) != 0) return 2;

  int depth = 0, color = -1, interlace = 0;
  bool header = false;
  uint8_t palette[256][3] = {};
  std::vector<uint8_t> idat;
  size_t pos = 8;
  for (;;) {
    if (pos + 12 > file.size()) return 3;  // no IEND
    uint32_t len = be32(&file[pos]);
    if (len > file.size() - pos - 12) return 3;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = type + 4;
    uLong crc = crc32(crc32(0L, Z_NULL, 0), type, len + 4);
    if (crc != be32(data + len)) return 3;
    if (!memcmp(type, "IHDR", 4)) {
      if (len != 13) return 3;
      W = be32(data);
      H = be32(data + 4);
      depth = data[8];
      color = data[9];
      if (data[10] != 0 || data[11] != 0) return 3;
      interlace = data[12];
      header = true;
    } else if (!memcmp(type, "PLTE", 4)) {
      if (len % 3 || len > 768) return 3;
      memcpy(palette, data, len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + (size_t)len;
  }
  if (!header || W == 0 || H == 0 || (uint64_t)W * H > (1ull << 28))
    return 3;
  int channels;
  switch (color) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return 3;
  }
  bool depth_ok = depth == 8 || (depth == 16 && color != 3) ||
                  ((depth == 1 || depth == 2 || depth == 4) &&
                   (color == 0 || color == 3));
  if (!depth_ok) return 3;
  if (interlace != 0 || (depth == 16 && (color == 2 || color == 6)))
    return 6;

  const size_t bits = (size_t)channels * depth;
  const size_t rowbytes = (W * bits + 7) / 8;
  const size_t bpp = std::max<size_t>(1, bits / 8);
  std::vector<uint8_t> raw(H * (rowbytes + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return 3;

  // undo the row filters in place: each row is a filter byte + rowbytes
  std::vector<uint8_t> zero(rowbytes, 0);
  const uint8_t* prev = zero.data();
  for (uint32_t y = 0; y < H; ++y) {
    uint8_t* row = &raw[y * (rowbytes + 1)];
    uint8_t ft = row[0];
    uint8_t* cur = row + 1;
    switch (ft) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < rowbytes; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) cur[i] += prev[i];
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i)
          cur[i] += (uint8_t)(((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1);
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i)
          cur[i] += paeth(i >= bpp ? cur[i - bpp] : 0, prev[i],
                          i >= bpp ? prev[i - bpp] : 0);
        break;
      default: return 3;
    }
    prev = cur;
  }

  img.resize((size_t)W * H);
  const int step = depth / 8 ? depth / 8 : 1;  // bytes per sample (>= 8 bit)
  for (uint32_t y = 0; y < H; ++y) {
    const uint8_t* s = &raw[y * (rowbytes + 1) + 1];
    uint8_t* d = &img[(size_t)y * W];
    if (depth < 8) {  // packed samples, most significant bits first
      const int per = 8 / depth, mask = (1 << depth) - 1;
      const int scale = 255 / mask;  // libpng's 1/2/4 -> 8 bit expansion
      for (uint32_t x = 0; x < W; ++x) {
        int v = (s[x / per] >> ((per - 1 - x % per) * depth)) & mask;
        d[x] = color == 3 ? rgb_gray(palette[v][0], palette[v][1],
                                     palette[v][2])
                          : (uint8_t)(v * scale);
      }
      continue;
    }
    for (uint32_t x = 0; x < W; ++x) {
      const uint8_t* p = s + (size_t)x * channels * step;  // high bytes
      switch (color) {
        case 0: case 4: d[x] = p[0]; break;
        case 2: case 6: d[x] = rgb_gray(p[0], p[1], p[2]); break;
        case 3: d[x] = rgb_gray(palette[p[0]][0], palette[p[0]][1],
                                palette[p[0]][2]); break;
      }
    }
  }
  return 0;
}

// Decode into a fixed (H, W) uint8 buffer, edge-replicate-padding
// bottom/right when the image is smaller (utils/kitti.pad_to_bucket).
int decode_padded_u8(const char* path, uint8_t* out, int32_t H, int32_t W) {
  std::vector<uint8_t> img;
  uint32_t w = 0, h = 0;
  int rc = decode_gray8(path, img, w, h);
  if (rc != 0) return rc;
  if ((int64_t)h > H || (int64_t)w > W) return 4;
  for (int32_t y = 0; y < H; ++y) {
    const uint8_t* src = &img[(size_t)std::min<uint32_t>(y, h - 1) * w];
    uint8_t* dst = out + (size_t)y * W;
    memcpy(dst, src, w);
    memset(dst + w, src[w - 1], (size_t)(W - w));
  }
  return 0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// 1. track-id chaining
// ---------------------------------------------------------------------------
//
// For each frame f >= 1 and current slot j with an inlier match to
// previous slot i = match_prev[f*K + j]: extend the previous slot's track,
// or issue a fresh id covering both frames. track_ids must be pre-filled
// with -1. Returns the number of tracks issued.
int32_t build_tracks(int32_t F, int32_t K, const int32_t* match_prev,
                     const uint8_t* inlier_prev, int32_t* track_ids) {
  int32_t next_track = 0;
  for (int32_t f = 1; f < F; ++f) {
    const int32_t* m = match_prev + (size_t)f * K;
    const uint8_t* inl = inlier_prev + (size_t)f * K;
    int32_t* prev_row = track_ids + (size_t)(f - 1) * K;
    int32_t* cur_row = track_ids + (size_t)f * K;
    for (int32_t j = 0; j < K; ++j) {
      if (!inl[j]) continue;
      int32_t i = m[j];
      if (i < 0 || i >= K) continue;
      int32_t tid = prev_row[i];
      if (tid < 0) {
        tid = next_track++;
        prev_row[i] = tid;
      }
      cur_row[j] = tid;
    }
  }
  return next_track;
}

// ---------------------------------------------------------------------------
// 2. PNG decode
// ---------------------------------------------------------------------------

// Decode to float32 [0, 1] (u8 * (1/255f), as the device converts uint8
// frames). out must hold max_h*max_w floats; rows are packed at the
// image's width, which *w receives (and *h its height).
int load_png_gray(const char* path, float* out, int32_t* h, int32_t* w,
                  int32_t max_h, int32_t max_w) {
  std::vector<uint8_t> img;
  uint32_t W = 0, H = 0;
  int rc = decode_gray8(path, img, W, H);
  if (rc != 0) return rc;
  if ((int64_t)H > max_h || (int64_t)W > max_w) return 4;
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < img.size(); ++i) out[i] = img[i] * inv;
  *h = (int32_t)H;
  *w = (int32_t)W;
  return 0;
}

// uint8 decode into (H, W), edge-replicate-padded; the image must not
// exceed (H, W).
int load_png_u8_padded(const char* path, uint8_t* out, int32_t H, int32_t W) {
  return decode_padded_u8(path, out, H, W);
}

// float32 [0, 1] decode into (H, W), edge-replicate-padded.
int load_png_gray_padded(const char* path, float* out, int32_t H, int32_t W) {
  std::vector<uint8_t> tmp((size_t)H * W);
  int rc = decode_padded_u8(path, tmp.data(), H, W);
  if (rc != 0) return rc;
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < tmp.size(); ++i) out[i] = tmp[i] * inv;
  return 0;
}

// ---------------------------------------------------------------------------
// 3. background stereo-chunk prefetcher
// ---------------------------------------------------------------------------

struct Chunk {
  int32_t n = 0;        // valid frames (tail chunks are partial)
  bool failed = false;  // a frame did not decode
  std::vector<uint8_t> planes;  // chunk*H*W left, then chunk*H*W right
};

struct Loader {
  std::vector<std::string> left, right;
  int32_t H = 0, W = 0, chunk = 0;
  int n_threads = 2;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::deque<Chunk> ready;
  size_t next_chunk = 0, total_chunks = 0, chunks_done = 0;
  size_t max_queue = 2;
  std::atomic<bool> stop{false};

  void run() {
    while (!stop.load()) {
      size_t c;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (next_chunk >= total_chunks) break;
        cv_space.wait(lk, [&] { return ready.size() < max_queue || stop; });
        if (stop.load()) break;
        c = next_chunk++;
      }
      size_t start = c * chunk;
      size_t n = std::min((size_t)chunk, left.size() - start);
      const size_t plane = (size_t)H * W;
      Chunk out;
      out.n = (int32_t)n;
      out.planes.assign(2 * (size_t)chunk * plane, 0);
      std::atomic<bool> failed{false};
      std::atomic<size_t> idx{0};
      // frames are independent: a small pool decodes them
      auto decode_some = [&]() {
        size_t k;
        while ((k = idx.fetch_add(1)) < 2 * n) {
          size_t f = k / 2;
          bool is_right = k % 2;
          const std::string& p = is_right ? right[start + f] : left[start + f];
          uint8_t* dst = out.planes.data() +
                         ((is_right ? (size_t)chunk : 0) + f) * plane;
          if (decode_padded_u8(p.c_str(), dst, H, W) != 0) failed = true;
        }
      };
      std::vector<std::thread> pool;
      for (int t = 1; t < n_threads; ++t) pool.emplace_back(decode_some);
      decode_some();
      for (auto& t : pool) t.join();
      out.failed = failed.load();
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(std::move(out));
        ++chunks_done;
      }
      cv_ready.notify_one();
    }
    cv_ready.notify_all();  // wake a consumer waiting at end of stream
  }
};

void* loader_create(const char** left_paths, const char** right_paths,
                    int32_t num_frames, int32_t H, int32_t W, int32_t chunk,
                    int32_t n_threads) {
  Loader* L = new Loader();
  L->left.assign(left_paths, left_paths + num_frames);
  L->right.assign(right_paths, right_paths + num_frames);
  L->H = H;
  L->W = W;
  L->chunk = chunk;
  L->n_threads = n_threads > 0 ? n_threads : 2;
  L->total_chunks = (num_frames + chunk - 1) / chunk;
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Blocks until the next chunk is decoded and copies it into out_left /
// out_right (each chunk*H*W bytes; frames past the valid count are zero).
// Returns the number of valid frames, 0 at the end, -1 if a frame of the
// chunk did not decode.
int32_t loader_next(void* handle, uint8_t* out_left, uint8_t* out_right) {
  Loader* L = (Loader*)handle;
  Chunk c;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] {
      return !L->ready.empty() || L->chunks_done >= L->total_chunks ||
             L->stop;
    });
    if (L->ready.empty()) return 0;
    c = std::move(L->ready.front());
    L->ready.pop_front();
  }
  L->cv_space.notify_one();
  size_t plane = (size_t)L->chunk * L->H * L->W;
  memcpy(out_left, c.planes.data(), plane);
  memcpy(out_right, c.planes.data() + plane, plane);
  return c.failed ? -1 : c.n;
}

void loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    // set under the lock: a thread that has just found its wait predicate
    // false is then already blocked, so the notifications reach it
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"
