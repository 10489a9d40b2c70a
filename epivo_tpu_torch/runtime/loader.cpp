// Native data-loading runtime: threaded PNG decode + prefetch ring buffer.
//
// TPU-native replacement for the reference's producer-thread pipeline
// (`kitti_ba.cpp:1118-1125`: an std::thread pushing decoded frames into
// unguarded shared vectors, with consumers busy-waiting at :207-209 etc.).
// This version keeps the same role — overlap image IO/decode with device
// compute — but with a real bounded ring buffer (mutex + condvars, no
// data races, no busy-wait), N decode workers, and a C ABI for Python
// (ctypes) consumption.
//
// Frames are decoded to float32 grayscale [H, W] in [0, 255], the exact
// tensor layout the device pipeline uploads, so Python's role is reduced
// to wrapping pointers.
//
// Build: see build.sh (links libpng + pthread).

#include <png.h>

#include <atomic>
#include <map>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> data;
  int height = 0;
  int width = 0;
  int index = -1;   // sequence position
  bool ok = false;  // decode success
};

// Decode one 8/16-bit gray or RGB(A) PNG to float32 grayscale [0,255].
bool decode_png_gray(const char* path, Frame* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // Normalize to 8-bit gray.
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (depth == 16) png_set_strip_16(png);
  if (depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);  // BT.709 luma
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out->data.resize(static_cast<size_t>(w) * h);
  out->height = static_cast<int>(h);
  out->width = static_cast<int>(w);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data.data() + static_cast<size_t>(y) * w;
    for (png_uint_32 x = 0; x < w; ++x) dst[x] = static_cast<float>(row[x]);
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  out->ok = true;
  return true;
}

class Prefetcher {
 public:
  Prefetcher(std::vector<std::string> paths, int n_workers, int capacity)
      : paths_(std::move(paths)),
        capacity_(capacity),
        next_to_decode_(0),
        next_to_emit_(0) {
    stop_.store(false);
    for (int i = 0; i < n_workers; ++i)
      workers_.emplace_back([this] { this->work(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_.store(true);
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Blocking in-order pop. Returns nullptr when the sequence is exhausted.
  Frame* next() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_ready_.wait(lk, [this] {
      return stop_.load() ||
             next_to_emit_ >= static_cast<int>(paths_.size()) ||
             ready_.count(next_to_emit_) > 0;
    });
    if (stop_.load() || next_to_emit_ >= static_cast<int>(paths_.size()))
      return nullptr;
    current_ = std::move(ready_[next_to_emit_]);
    ready_.erase(next_to_emit_);
    ++next_to_emit_;
    cv_space_.notify_all();
    return &current_;
  }

 private:
  void work() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] {
          return stop_.load() ||
                 (next_to_decode_ < static_cast<int>(paths_.size()) &&
                  static_cast<int>(ready_.size()) + in_flight_ < capacity_);
        });
        if (stop_.load() || next_to_decode_ >= static_cast<int>(paths_.size()))
          return;
        idx = next_to_decode_++;
        ++in_flight_;
      }
      Frame f;
      f.index = idx;
      decode_png_gray(paths_[idx].c_str(), &f);
      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_[idx] = std::move(f);
        --in_flight_;
      }
      cv_ready_.notify_all();
      cv_space_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  int capacity_;
  int next_to_decode_;
  int next_to_emit_;
  int in_flight_ = 0;
  std::map<int, Frame> ready_;
  Frame current_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::atomic<bool> stop_;
};

}  // namespace

extern "C" {

// ---- one-shot decode ----
// Returns handle to a decoded frame (caller frees with epivo_frame_free).
void* epivo_decode_png(const char* path) {
  auto* f = new Frame();
  if (!decode_png_gray(path, f)) {
    delete f;
    return nullptr;
  }
  return f;
}

int epivo_frame_height(void* frame) { return static_cast<Frame*>(frame)->height; }
int epivo_frame_width(void* frame) { return static_cast<Frame*>(frame)->width; }
const float* epivo_frame_data(void* frame) {
  return static_cast<Frame*>(frame)->data.data();
}
void epivo_frame_free(void* frame) { delete static_cast<Frame*>(frame); }

// ---- prefetching sequence loader ----
// paths: '\n'-joined file list. Returns a loader handle.
void* epivo_loader_open(const char* paths_joined, int n_workers, int capacity) {
  std::vector<std::string> paths;
  const char* p = paths_joined;
  while (*p) {
    const char* q = strchr(p, '\n');
    if (!q) {
      paths.emplace_back(p);
      break;
    }
    paths.emplace_back(p, q - p);
    p = q + 1;
  }
  if (paths.empty()) return nullptr;
  if (n_workers < 1) n_workers = 1;
  if (capacity < 2) capacity = 2;
  return new Prefetcher(std::move(paths), n_workers, capacity);
}

// Blocking: returns pointer to the next in-order frame, or nullptr at end.
// The returned frame stays valid until the following next()/close() call.
void* epivo_loader_next(void* loader) {
  return static_cast<Prefetcher*>(loader)->next();
}

void epivo_loader_close(void* loader) { delete static_cast<Prefetcher*>(loader); }

}  // extern "C"
