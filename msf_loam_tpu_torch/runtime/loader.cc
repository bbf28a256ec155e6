// Native host runtime: KITTI .bin reading + scan ingest preprocessing +
// threaded prefetch.
//
// The C++ counterpart of the reference's host-bound ingest path — rosbag
// reading + RemoveInvalidPointsFromCloud + ComputeRelaTimeForEachPoint +
// per-ring grouping (the reference's msf_loam_node.cc:85-195,
// kitti_helper.cc:21-32) — rebuilt as a flat C API so the Python pipeline
// feeds fixed-shape device buffers without touching numpy on the hot path.
// Exposed via ctypes from msf_loam_tpu_torch/runtime/__init__.py (the
// PyTorch port's copy of the JAX package's loader, unchanged).

#include <atomic>
#include <cmath>
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

constexpr double kTwoPi = 6.283185307179586476925286766559;

struct RingImageOut {
  float* xyz;       // R*W*3
  float* rel_time;  // R*W
  uint8_t* mask;    // R*W
  int n_rings;
  int width;
};

// Elevation-angle ring binning for datasets without a ring field (the
// reference leaves ring assignment as a TODO for KITTI, kitti_helper.cc:152).
inline int InferRing(float x, float y, float z, int n_rings, float fov_up,
                     float fov_down) {
  const float d = std::sqrt(x * x + y * y);
  const float elev = std::atan2(z, d) * 57.29577951308232f;  // degrees
  float frac = (fov_up - elev) / (fov_up - fov_down);
  int ring = static_cast<int>(std::lround(frac * (n_rings - 1)));
  if (ring < 0) ring = 0;
  if (ring >= n_rings) ring = n_rings - 1;
  return ring;
}

int PreprocessScan(const float* xyz, const int32_t* ring_in, int n_points,
                   float min_range, float scan_period, int n_rings,
                   float fov_up, float fov_down, RingImageOut out) {
  const int R = out.n_rings;
  const int W = out.width;
  std::memset(out.xyz, 0, sizeof(float) * R * W * 3);
  std::memset(out.rel_time, 0, sizeof(float) * R * W);
  std::memset(out.mask, 0, sizeof(uint8_t) * R * W);

  std::vector<int> counts(R, 0);
  std::vector<double> run_max(R, -1e300);
  std::vector<uint8_t> ring_wrapped(R, 0);

  // start azimuth from the first VALID point (msf_loam_node.cc:131 uses the
  // raw first point; invalid leaders would poison atan2 — filter first)
  double start_ori = 0.0;
  bool have_start = false;
  int n_kept = 0;

  const float min_range_sq = min_range * min_range;
  for (int i = 0; i < n_points; ++i) {
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    const float r2 = x * x + y * y + z * z;
    if (r2 < min_range_sq) continue;

    int ring = ring_in ? ring_in[i]
                       : InferRing(x, y, z, n_rings, fov_up, fov_down);
    if (ring < 0 || ring >= R) continue;

    const double ori = -std::atan2((double)y, (double)x);
    if (!have_start) {
      start_ori = ori;
      have_start = true;
    }
    // Noise-robust relative azimuth + per-ring unwrap (mirrors
    // preprocess.compute_relative_time, kept bit-comparable): the mod
    // window is shifted by kStartMargin so near-start jitter lands at ~0
    // instead of ~2pi, and a wrap is only declared on a genuine ~2pi drop
    // (run_max - rel > pi), sticky for the rest of the ring. A plain
    // running-max unwrap shifts entire rings by +2pi when the first
    // column's azimuth jitters just before start_ori.
    constexpr double kStartMargin = 0.26179938779914943653855361527329;  // pi/12
    double rel =
        std::fmod(ori - start_ori + kStartMargin + kTwoPi, kTwoPi) -
        kStartMargin;
    if (!ring_wrapped[ring] && run_max[ring] - rel > kTwoPi / 2.0) {
      ring_wrapped[ring] = 1;
    }
    if (rel > run_max[ring]) run_max[ring] = rel;
    if (ring_wrapped[ring]) rel += kTwoPi;
    if (rel < 0.0) rel = 0.0;
    const float rel_time =
        static_cast<float>(rel / kTwoPi * (double)scan_period);

    const int c = counts[ring];
    if (c >= W) continue;  // row full: drop overflow (fixed-shape contract)
    const int base = ring * W + c;
    out.xyz[3 * base] = x;
    out.xyz[3 * base + 1] = y;
    out.xyz[3 * base + 2] = z;
    out.rel_time[base] = rel_time;
    out.mask[base] = 1;
    counts[ring] = c + 1;
    ++n_kept;
  }
  return n_kept;
}

// ---------------------------------------------------------------------------
// Threaded KITTI prefetcher: worker threads read + preprocess frames ahead
// of the (sequential) SLAM consumer. Plays the role of the reference's ROS
// AsyncSpinner callback pool feeding the mapping thread through a queue
// (msf_loam_node.cc:476, laser_mapping.cc:125-158) — but for file ingest.
// ---------------------------------------------------------------------------

struct Frame {
  int index = -1;
  int n_kept = 0;
  std::vector<float> xyz;
  std::vector<float> rel_time;
  std::vector<uint8_t> mask;
};

struct Prefetcher {
  std::string dir;
  int n_frames;
  int n_rings;
  int width;
  float min_range;
  float scan_period;
  float fov_up, fov_down;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::queue<Frame> ready;            // completed frames, ordered by index
  int next_to_produce = 0;            // claimed by workers
  int next_to_emit = 0;               // next index the consumer expects
  std::vector<Frame> out_of_order;    // completed but not yet emittable
  size_t max_queue = 8;
  std::atomic<bool> stop{false};
};

Frame LoadOne(Prefetcher* p, int idx) {
  Frame f;
  f.index = idx;
  f.xyz.resize((size_t)p->n_rings * p->width * 3);
  f.rel_time.resize((size_t)p->n_rings * p->width);
  f.mask.resize((size_t)p->n_rings * p->width);

  char path[4096];
  std::snprintf(path, sizeof(path), "%s/%06d.bin", p->dir.c_str(), idx);
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return f;
  std::fseek(fp, 0, SEEK_END);
  const long bytes = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  const int n_pts = (int)(bytes / (4 * sizeof(float)));
  std::vector<float> raw((size_t)n_pts * 4);
  const size_t got = std::fread(raw.data(), sizeof(float), (size_t)n_pts * 4, fp);
  std::fclose(fp);
  if (got != (size_t)n_pts * 4) return f;

  std::vector<float> xyz((size_t)n_pts * 3);
  for (int i = 0; i < n_pts; ++i) {
    xyz[3 * i] = raw[4 * i];
    xyz[3 * i + 1] = raw[4 * i + 1];
    xyz[3 * i + 2] = raw[4 * i + 2];
  }
  RingImageOut out{f.xyz.data(), f.rel_time.data(), f.mask.data(),
                   p->n_rings, p->width};
  f.n_kept = PreprocessScan(xyz.data(), nullptr, n_pts, p->min_range,
                            p->scan_period, p->n_rings, p->fov_up,
                            p->fov_down, out);
  return f;
}

void WorkerLoop(Prefetcher* p) {
  while (!p->stop.load()) {
    int idx;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      if (p->next_to_produce >= p->n_frames) return;
      p->cv_space.wait(lk, [p] {
        return p->stop.load() ||
               p->ready.size() + p->out_of_order.size() < p->max_queue;
      });
      if (p->stop.load()) return;
      idx = p->next_to_produce++;
    }
    Frame f = LoadOne(p, idx);
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->out_of_order.push_back(std::move(f));
      // drain in-order completions into the ready queue
      bool advanced = true;
      while (advanced) {
        advanced = false;
        for (size_t i = 0; i < p->out_of_order.size(); ++i) {
          if (p->out_of_order[i].index == p->next_to_emit) {
            p->ready.push(std::move(p->out_of_order[i]));
            p->out_of_order.erase(p->out_of_order.begin() + i);
            p->next_to_emit++;
            advanced = true;
            break;
          }
        }
      }
      p->cv_ready.notify_all();
    }
  }
}

}  // namespace

extern "C" {

// One-shot preprocessing (no threading): ring_in may be null.
int msf_preprocess_scan(const float* xyz, const int32_t* ring_in, int n_points,
                        float min_range, float scan_period, int n_rings,
                        int width, float fov_up, float fov_down,
                        float* out_xyz, float* out_rel, uint8_t* out_mask) {
  RingImageOut out{out_xyz, out_rel, out_mask, n_rings, width};
  return PreprocessScan(xyz, ring_in, n_points, min_range, scan_period,
                        n_rings, fov_up, fov_down, out);
}

// Read a KITTI .bin into caller-provided xyzi buffer; returns point count.
int msf_read_kitti_bin(const char* path, float* out_xyzi, int max_points) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, 0, SEEK_END);
  const long bytes = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  int n = (int)(bytes / (4 * sizeof(float)));
  if (n > max_points) n = max_points;
  const size_t got = std::fread(out_xyzi, sizeof(float), (size_t)n * 4, fp);
  std::fclose(fp);
  return (int)(got / 4);
}

void* msf_prefetcher_create(const char* velodyne_dir, int n_frames,
                            int n_rings, int width, float min_range,
                            float scan_period, float fov_up, float fov_down,
                            int n_threads) {
  auto* p = new Prefetcher();
  p->dir = velodyne_dir;
  p->n_frames = n_frames;
  p->n_rings = n_rings;
  p->width = width;
  p->min_range = min_range;
  p->scan_period = scan_period;
  p->fov_up = fov_up;
  p->fov_down = fov_down;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i) {
    p->workers.emplace_back(WorkerLoop, p);
  }
  return p;
}

// Blocks until the next in-order frame is ready; returns its index or -1 at
// end of sequence. Buffers must hold R*W*3 / R*W / R*W entries.
int msf_prefetcher_next(void* handle, float* out_xyz, float* out_rel,
                        uint8_t* out_mask, int* out_n_kept) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [p] {
    return p->stop.load() || !p->ready.empty() ||
           (p->next_to_emit >= p->n_frames && p->ready.empty());
  });
  if (p->ready.empty()) return -1;
  Frame f = std::move(p->ready.front());
  p->ready.pop();
  p->cv_space.notify_all();
  lk.unlock();
  std::memcpy(out_xyz, f.xyz.data(), f.xyz.size() * sizeof(float));
  std::memcpy(out_rel, f.rel_time.data(), f.rel_time.size() * sizeof(float));
  std::memcpy(out_mask, f.mask.data(), f.mask.size());
  *out_n_kept = f.n_kept;
  return f.index;
}

void msf_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
