// Native ShapeNet-part .pts/.seg loader: threaded parse + fixed-N resample.
//
// A copy of the JAX package's native/pts_loader.cpp (same parser, same
// per-shape xorshift64* resample stream, so both packages read a pts
// fixture into the same arrays). The reference's data layer reads
// per-shape text files with numpy.loadtxt and resamples with
// np.random.choice inside Dataset.__getitem__ (upstream:dataset.py,
// SURVEY.md §2.1); this is a C++ thread pool with a hand-rolled float
// parser that resamples each shape to a fixed N (deterministic given the
// seed) and writes straight into the caller's rectangular numpy buffers.
//
// Exposed via ctypes; see native/build.py and data/native_loader.py. A
// numpy path keeps the package working when no C++ toolchain is present.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// xorshift64* — deterministic, per-shape seeded.
inline uint64_t xorshift(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

// Fast positive/negative decimal float parse (no exponent forms appear in
// .pts files; falls back to strtof when one does).
inline const char* parse_float(const char* p, const char* end, float* out) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  if (p >= end) return nullptr;
  const char* start = p;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') { ++p; }
  double val = 0.0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    val = val * 10.0 + (*p - '0');
    ++p; any = true;
  }
  if (p < end && *p == '.') {
    ++p;
    double frac = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      val += (*p - '0') * frac;
      frac *= 0.1;
      ++p; any = true;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {  // rare: defer to strtof
    char* q = nullptr;
    val = strtof(start, &q);
    p = q;
  } else if (!any) {
    return nullptr;
  }
  *out = neg ? -static_cast<float>(val) : static_cast<float>(val);
  return p;
}

struct FileBuf {
  std::vector<char> data;
  bool ok = false;
};

FileBuf read_file(const char* path) {
  FileBuf fb;
  FILE* f = fopen(path, "rb");
  if (!f) return fb;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  fb.data.resize(static_cast<size_t>(sz));
  fb.ok = fread(fb.data.data(), 1, fb.data.size(), f) == fb.data.size();
  fclose(f);
  return fb;
}

}  // namespace

extern "C" {

// Parse one .pts file into out[max_pts*3]; returns point count (or -1).
int parse_pts_file(const char* path, float* out, int max_pts) {
  FileBuf fb = read_file(path);
  if (!fb.ok) return -1;
  const char* p = fb.data.data();
  const char* end = p + fb.data.size();
  int n = 0;
  float v[3];
  while (n < max_pts) {
    const char* q = p;
    bool row_ok = true;
    for (int c = 0; c < 3; ++c) {
      q = parse_float(q, end, &v[c]);
      if (!q) { row_ok = false; break; }
    }
    if (!row_ok) break;
    out[n * 3 + 0] = v[0];
    out[n * 3 + 1] = v[1];
    out[n * 3 + 2] = v[2];
    ++n;
    p = q;
  }
  return n;
}

// Parse one .seg label file; returns count (or -1).
int parse_seg_file(const char* path, int* out, int max_pts) {
  FileBuf fb = read_file(path);
  if (!fb.ok) return -1;
  const char* p = fb.data.data();
  const char* end = p + fb.data.size();
  int n = 0;
  while (n < max_pts) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p >= end || *p < '0' || *p > '9') break;
    int val = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      val = val * 10 + (*p - '0');
      ++p;
    }
    out[n++] = val;
  }
  return n;
}

// Threaded batch load: parse n_shapes (pts[, seg]) file pairs, resample
// each to num_points with replacement (per-shape xorshift stream seeded
// by seed+shape index), write rectangular outputs. seg_paths may be null
// (classification datasets). part_offset[i] is added to every label of
// shape i (the category->global part-id shift). Returns 0 on success,
// else 1-based index of the first failing shape.
int load_shapes(const char** pts_paths, const char** seg_paths,
                const int* part_offset, int n_shapes, int num_points,
                uint64_t seed, float* out_pts, int* out_seg,
                int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 4;
  std::vector<int> status(static_cast<size_t>(n_shapes), 0);

  auto work = [&](int tid) {
    constexpr int kMax = 1 << 17;  // 131072 raw points per shape max
    std::vector<float> pts(kMax * 3);
    std::vector<int> seg(kMax);
    for (int i = tid; i < n_shapes; i += n_threads) {
      int n = parse_pts_file(pts_paths[i], pts.data(), kMax);
      if (n <= 0) { status[i] = 1; continue; }
      int nseg = 0;
      if (seg_paths) {
        nseg = parse_seg_file(seg_paths[i], seg.data(), kMax);
        if (nseg != n) { status[i] = 2; continue; }
      }
      uint64_t rs = seed + 0x9E3779B97F4A7C15ULL * (uint64_t)(i + 1);
      int off = part_offset ? part_offset[i] : 0;
      for (int j = 0; j < num_points; ++j) {
        int src = static_cast<int>(xorshift(&rs) % (uint64_t)n);
        const float* sp = &pts[src * 3];
        float* dp = &out_pts[((size_t)i * num_points + j) * 3];
        dp[0] = sp[0]; dp[1] = sp[1]; dp[2] = sp[2];
        if (seg_paths && out_seg)
          out_seg[(size_t)i * num_points + j] = seg[src] + off;
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  for (auto& t : threads) t.join();
  for (int i = 0; i < n_shapes; ++i)
    if (status[i]) return i + 1;
  return 0;
}

}  // extern "C"
