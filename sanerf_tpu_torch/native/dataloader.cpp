// Native data loader of the PyTorch port: threaded, prefetching ray-batch
// sampler (the port's own copy of native/dataloader.cpp, built by
// sanerf_tpu_torch/data/native_loader.py into build/native/).
//
// At stage-1 step rates (40+ steps/s, 8k rays a step) the Python collate
// (RNG + gather + ray math) becomes host-bound; this C++ pipeline keeps a
// ring of ready batches ahead of the device so the train loop does not
// stall on the host.
//
// Design:
//  - images preloaded as uint8 planes in host memory; batches are copied
//    to the device each step.
//  - worker threads draw (image, pixel) samples with a per-thread xorshift
//    RNG, compute OpenGL-convention rays (matching data/rays.py exactly:
//    +0.5 pixel centers, x=(i-cx)/fx, y=-(j-cy)/fy, z=-1, rotate by c2w),
//    gather rgb, and publish into a bounded ring buffer.
//  - the consumer (`snl_next`) pops a ready batch or blocks briefly.
//
// C ABI only (ctypes-friendly); no Python.h dependency.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<float> rays_o, rays_d, rgb;
  int image_index;
};

struct Sampler {
  // scene data (borrowed or copied at create time)
  std::vector<float> poses;       // [M, 16] row-major c2w
  std::vector<float> intrinsics;  // [M, 4] (fx, fy, cx, cy) per image
  std::vector<uint8_t> images;    // [M, H, W, 3]
  int M = 0, H = 0, W = 0, num_rays = 0;

  // pipeline
  std::vector<std::thread> workers;
  std::queue<Batch> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t prefetch_depth = 4;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> seed{0};

  ~Sampler() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  static inline uint64_t xorshift(uint64_t& s) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }

  void make_batch(Batch& b, uint64_t& rng) {
    b.rays_o.resize(num_rays * 3);
    b.rays_d.resize(num_rays * 3);
    b.rgb.resize(num_rays * 3);
    const int img = static_cast<int>(xorshift(rng) % static_cast<uint64_t>(M));
    b.image_index = img;
    const float* P = poses.data() + img * 16;
    const float fx = intrinsics[img * 4 + 0], fy = intrinsics[img * 4 + 1];
    const float cx = intrinsics[img * 4 + 2], cy = intrinsics[img * 4 + 3];
    const uint8_t* plane = images.data() + static_cast<size_t>(img) * H * W * 3;
    const float ox = P[3], oy = P[7], oz = P[11];

    for (int r = 0; r < num_rays; ++r) {
      const uint64_t v = xorshift(rng);
      const int px = static_cast<int>(v % static_cast<uint64_t>(W));
      const int py = static_cast<int>((v >> 20) % static_cast<uint64_t>(H));
      const float i = px + 0.5f, j = py + 0.5f;
      const float dx = (i - cx) / fx;
      const float dy = -(j - cy) / fy;
      const float dz = -1.0f;
      // rays_d = R @ d  (c2w rotation is P[0..2], P[4..6], P[8..10])
      b.rays_d[r * 3 + 0] = P[0] * dx + P[1] * dy + P[2] * dz;
      b.rays_d[r * 3 + 1] = P[4] * dx + P[5] * dy + P[6] * dz;
      b.rays_d[r * 3 + 2] = P[8] * dx + P[9] * dy + P[10] * dz;
      b.rays_o[r * 3 + 0] = ox;
      b.rays_o[r * 3 + 1] = oy;
      b.rays_o[r * 3 + 2] = oz;
      const uint8_t* px3 = plane + (static_cast<size_t>(py) * W + px) * 3;
      b.rgb[r * 3 + 0] = px3[0] / 255.0f;
      b.rgb[r * 3 + 1] = px3[1] / 255.0f;
      b.rgb[r * 3 + 2] = px3[2] / 255.0f;
    }
  }

  void worker_loop(uint64_t rng) {
    if (rng == 0) rng = 0x9E3779B97F4A7C15ull;
    while (!stop.load()) {
      Batch b;
      make_batch(b, rng);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return stop.load() || ready.size() < prefetch_depth; });
      if (stop.load()) return;
      ready.push(std::move(b));
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* snl_create(const float* poses, const float* intrinsics,
                 const uint8_t* images, int M, int H, int W, int num_rays,
                 uint64_t seed, int prefetch_depth, int n_threads) {
  auto* s = new Sampler();
  s->M = M;
  s->H = H;
  s->W = W;
  s->num_rays = num_rays;
  s->prefetch_depth = prefetch_depth > 0 ? prefetch_depth : 4;
  s->poses.assign(poses, poses + static_cast<size_t>(M) * 16);
  s->intrinsics.assign(intrinsics, intrinsics + static_cast<size_t>(M) * 4);
  s->images.assign(images, images + static_cast<size_t>(M) * H * W * 3);
  if (n_threads <= 0) n_threads = 2;
  for (int t = 0; t < n_threads; ++t) {
    uint64_t rng = seed * 0x9E3779B97F4A7C15ull + 0xBF58476D1CE4E5B9ull * (t + 1);
    s->workers.emplace_back([s, rng] { const_cast<Sampler*>(s)->worker_loop(rng); });
  }
  return s;
}

// Pops one ready batch (blocking). Buffers must hold num_rays*3 floats.
void snl_next(void* handle, float* rays_o, float* rays_d, float* rgb,
              int* image_index) {
  auto* s = static_cast<Sampler*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_ready.wait(lk, [&] { return s->stop.load() || !s->ready.empty(); });
    if (s->ready.empty()) return;  // shutting down
    b = std::move(s->ready.front());
    s->ready.pop();
    s->cv_space.notify_one();
  }
  std::memcpy(rays_o, b.rays_o.data(), b.rays_o.size() * sizeof(float));
  std::memcpy(rays_d, b.rays_d.data(), b.rays_d.size() * sizeof(float));
  std::memcpy(rgb, b.rgb.data(), b.rgb.size() * sizeof(float));
  *image_index = b.image_index;
}

int snl_ready_count(void* handle) {
  auto* s = static_cast<Sampler*>(handle);
  std::lock_guard<std::mutex> lk(s->mu);
  return static_cast<int>(s->ready.size());
}

void snl_destroy(void* handle) { delete static_cast<Sampler*>(handle); }

}  // extern "C"
