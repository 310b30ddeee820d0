// ThreadSanitizer test program for the threaded part of the port's native
// runtime: the stereo prefetcher (native.cpp, section 3), a worker thread
// with a pool of decode threads filling a bounded queue.
//
// runtime/tsan.py builds this file with -fsanitize=thread and fails on any
// ThreadSanitizer report. Usage: tsan_main <png_dir> <F> <H> <W>, where
// <png_dir> holds l000.png.. and r000.png.. (F frames of H x W) and
// bad.png, a file that is not a PNG. It exercises: full streams into
// caller-given buffers (each frame checked against a direct decode),
// repeated create/destroy, a destroy mid-stream, two consumers draining
// one loader, and a corrupt frame, which must make its chunk fail (-1),
// not come back blank.

#include "native.cpp"

#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

namespace {

int fail(const char* what) {
  fprintf(stderr, "tsan_main: FAILED: %s\n", what);
  return 1;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s <png_dir> <F> <H> <W>\n", argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  const int F = atoi(argv[2]), H = atoi(argv[3]), W = atoi(argv[4]);
  const int chunk = 4, threads = 3;
  const size_t plane = (size_t)H * W, block = (size_t)chunk * plane;

  std::vector<std::string> ls, rs;
  for (int i = 0; i < F; ++i) {
    char b[32];
    snprintf(b, sizeof b, "/l%03d.png", i);
    ls.push_back(dir + b);
    snprintf(b, sizeof b, "/r%03d.png", i);
    rs.push_back(dir + b);
  }
  std::vector<const char*> lp, rp;
  for (auto& s : ls) lp.push_back(s.c_str());
  for (auto& s : rs) rp.push_back(s.c_str());

  // every frame decoded directly, on this thread
  std::vector<uint8_t> ref_l(F * plane), ref_r(F * plane);
  for (int i = 0; i < F; ++i)
    if (decode_padded_u8(lp[i], &ref_l[i * plane], H, W) ||
        decode_padded_u8(rp[i], &ref_r[i * plane], H, W))
      return fail("a fixture frame does not decode");

  // 1. full streams into caller-given buffers, frame by frame as decoded
  for (int round = 0; round < 3; ++round) {
    void* h = loader_create(lp.data(), rp.data(), F, H, W, chunk, threads);
    std::vector<uint8_t> L(block), R(block);
    int total = 0, n;
    while ((n = loader_next(h, L.data(), R.data())) > 0) {
      if (memcmp(L.data(), &ref_l[total * plane], n * plane) ||
          memcmp(R.data(), &ref_r[total * plane], n * plane))
        return fail("a streamed frame differs from its direct decode");
      total += n;
    }
    loader_destroy(h);
    if (n < 0 || total != F) return fail("a full stream ended early");
    printf("round %d streamed %d frames, equal to direct decodes\n", round,
           total);
  }

  // 2. repeated create / destroy, most before the first chunk is ready
  for (int k = 0; k < 20; ++k)
    loader_destroy(
        loader_create(lp.data(), rp.data(), F, H, W, chunk, threads));
  printf("20 create/destroy ok\n");

  // 3. destroy mid-stream: the stop flag and the wakeups
  for (int k = 0; k < 5; ++k) {
    void* h = loader_create(lp.data(), rp.data(), F, H, W, chunk, threads);
    std::vector<uint8_t> L(block), R(block);
    loader_next(h, L.data(), R.data());
    loader_destroy(h);
  }
  printf("mid-stream destroy ok\n");

  // 4. two consumers draining one loader: every chunk served once
  {
    void* h = loader_create(lp.data(), rp.data(), F, H, W, chunk, threads);
    int got[2] = {0, 0};
    auto drain = [&](int who) {
      std::vector<uint8_t> L(block), R(block);
      int n;
      while ((n = loader_next(h, L.data(), R.data())) > 0) got[who] += n;
    };
    std::thread a(drain, 0), b(drain, 1);
    a.join();
    b.join();
    loader_destroy(h);
    if (got[0] + got[1] != F) return fail("two consumers lost frames");
    printf("two consumers ok (%d + %d frames)\n", got[0], got[1]);
  }

  // 5. a corrupt frame: its chunk fails, the others stream
  {
    const std::string bad = dir + "/bad.png";
    std::vector<const char*> lb = lp;
    const int bad_at = chunk + 1;  // in the second chunk
    lb[bad_at] = bad.c_str();
    void* h = loader_create(lb.data(), rp.data(), F, H, W, chunk, threads);
    std::vector<uint8_t> L(block), R(block);
    int n, c = 0, failed = -1;
    while ((n = loader_next(h, L.data(), R.data())) != 0) {
      if (n < 0) failed = c;
      ++c;
    }
    loader_destroy(h);
    if (failed != bad_at / chunk || c != (F + chunk - 1) / chunk)
      return fail("a corrupt frame did not fail its chunk alone");
    printf("corrupt frame failed chunk %d of %d\n", failed, c);
  }
  return 0;
}
