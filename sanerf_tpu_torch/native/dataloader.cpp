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
//  - worker threads claim batch numbers in order (0, 1, 2, ...) and draw
//    batch k's (image, pixel) samples with a xorshift RNG seeded from
//    (seed, k) alone, so every batch is a function of the seed and its
//    number, whichever thread draws it; they compute OpenGL-convention
//    rays (matching data/rays.py exactly: +0.5 pixel centers,
//    x=(i-cx)/fx, y=-(j-cy)/fy, z=-1, rotate by c2w), gather rgb, and
//    publish batch k into a bounded ring of prefetch_depth slots.
//  - the consumer (`snl_next`) takes the batches in their order: it pops
//    batch k, blocking until that one is ready.
//
// C ABI only (ctypes-friendly); no Python.h dependency.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
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
  std::map<uint64_t, Batch> ready;  // finished batches by their number
  uint64_t next_claim = 0;           // the number the next worker draws
  uint64_t next_pop = 0;             // the number the consumer takes next
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  uint64_t prefetch_depth = 4;
  std::atomic<bool> stop{false};
  uint64_t seed = 0;

  ~Sampler() { shutdown(); }

  void shutdown() {
    {
      // under the lock: a worker between its predicate and its wait
      // cannot miss the wake-up
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
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

  static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
  }

  // batch k's xorshift state: a function of (seed, k) only, never 0
  uint64_t batch_rng(uint64_t k) const {
    const uint64_t s = splitmix64(seed ^ splitmix64(k));
    return s ? s : 0x9E3779B97F4A7C15ull;
  }

  void worker_loop() {
    while (true) {
      uint64_t k;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || next_claim < next_pop + prefetch_depth;
        });
        if (stop.load()) return;
        k = next_claim++;
      }
      Batch b;
      uint64_t rng = batch_rng(k);
      make_batch(b, rng);
      std::lock_guard<std::mutex> lk(mu);
      ready.emplace(k, std::move(b));
      cv_ready.notify_all();
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
  s->seed = seed;
  s->poses.assign(poses, poses + static_cast<size_t>(M) * 16);
  s->intrinsics.assign(intrinsics, intrinsics + static_cast<size_t>(M) * 4);
  s->images.assign(images, images + static_cast<size_t>(M) * H * W * 3);
  if (n_threads <= 0) n_threads = 2;
  for (int t = 0; t < n_threads; ++t)
    s->workers.emplace_back([s] { s->worker_loop(); });
  return s;
}

// Pops the next batch in order (blocking until it is ready). Buffers must
// hold num_rays*3 floats.
void snl_next(void* handle, float* rays_o, float* rays_d, float* rgb,
              int* image_index) {
  auto* s = static_cast<Sampler*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_ready.wait(lk, [&] {
      return s->stop.load() || s->ready.count(s->next_pop) != 0;
    });
    auto it = s->ready.find(s->next_pop);
    if (it == s->ready.end()) return;  // shutting down
    b = std::move(it->second);
    s->ready.erase(it);
    ++s->next_pop;
    s->cv_space.notify_all();
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
