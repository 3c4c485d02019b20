// Native streaming window batcher of the PyTorch port.
//
// A copy of the JAX package's native/am_dataloader.cc (the port builds and
// loads its own; see audio_metrics_tpu_torch/parallel/native_loader.py).
// A background thread consumes whole songs and produces fixed-size padded
// batches: window slicing, song/window reservoir shuffles with a min-age
// constraint, misaligned-pair construction and batch assembly all run off
// the GIL, overlapping with the card's work on the batch before.
//
// Data path: a song is copied ONCE at feed(); every window is a zero-copy
// view (shared_ptr song + frame offset) through slicing and both shuffles,
// and materializes only when written into a batch bucket (aligned: one
// memcpy; stem / misaligned: one strided de-/re-interleave straight into
// the bucket).  next_batch() copies a finished batch into the caller's
// buffer, which may be pinned host memory for an asynchronous upload.
//
// Built at first use by native_loader.py: g++ -O3 -std=c++17 -fPIC -pthread
// -shared.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr int kCatAligned = 1;
constexpr int kCatMisaligned = 2;
constexpr int kCatStem = 3;

constexpr int kKindPair = 0;
constexpr int kKindMono = 1;

// A view into a shared song buffer: interleaved (n x channels) samples
// starting at frame `offset`.  Copying a Window copies a shared_ptr.
struct Window {
  std::shared_ptr<const std::vector<float>> src;
  int64_t offset = 0;  // in frames
  int channels = 0;

  const float* ptr() const { return src->data() + offset * channels; }
};

struct Batch {
  std::vector<float> audio;       // batch * win_len * channels
  std::vector<int32_t> category;  // batch
  std::vector<uint8_t> valid;     // batch
  int kind = kKindMono;
  int n = 0;
};

// Reservoir shuffle with a minimum re-emission age, mirroring the semantics
// of parallel/shuffle.py (eligible window of size total - min_age rotating
// through the buffer).
template <typename T>
class ShuffleStream {
 public:
  ShuffleStream(size_t buffer_size, size_t min_age, uint64_t seed)
      : buffer_size_(buffer_size), min_age_(min_age), rng_(seed) {}

  // Push an item; may emit one item via `out`.  Returns true if emitted.
  bool push(T item, T* out) {
    if (buffer_.size() < buffer_size_) {
      buffer_.push_back(std::move(item));
      indices_.push_back(buffer_.size() - 1);
      if (buffer_.size() == buffer_size_) init_window();
      return false;
    }
    size_t pos = rng_() % n_eligible_;
    size_t j = (offset_ + pos) % buffer_.size();
    size_t idx = indices_[j];
    *out = std::move(buffer_[idx]);
    buffer_[idx] = std::move(item);
    std::swap(indices_[j], indices_[offset_]);
    offset_ = (offset_ + 1) % buffer_.size();
    return true;
  }

  // Drain remaining items in random order.
  std::vector<T> finish() {
    if (!initialized_ && !buffer_.empty()) init_window();
    std::shuffle(indices_.begin(), indices_.end(), rng_);
    std::vector<T> out;
    out.reserve(buffer_.size());
    for (size_t idx : indices_) out.push_back(std::move(buffer_[idx]));
    buffer_.clear();
    indices_.clear();
    return out;
  }

 private:
  void init_window() {
    size_t total = buffer_.size();
    size_t eff = std::min(min_age_, total - 1);
    n_eligible_ = total - eff;
    offset_ = 0;
    initialized_ = true;
  }

  size_t buffer_size_, min_age_;
  std::vector<T> buffer_;
  std::vector<size_t> indices_;
  size_t offset_ = 0;
  size_t n_eligible_ = 1;
  bool initialized_ = false;
  std::mt19937_64 rng_;
};

class Loader {
 public:
  Loader(int batch_size, int win_len, int apa_mode, int stems_mode,
         int song_buffer, int win_buffer, int win_min_age, uint64_t seed,
         int max_ready_batches)
      : batch_size_(batch_size),
        win_len_(win_len),
        apa_mode_(apa_mode),
        stems_mode_(stems_mode),
        max_ready_(max_ready_batches),
        song_shuffle_(song_buffer, 0, seed ^ 0x9e3779b97f4a7c15ULL),
        win_shuffle_(win_buffer, win_min_age, seed) {
    worker_ = std::thread([this] { run(); });
  }

  ~Loader() {
    cancel();
    if (worker_.joinable()) worker_.join();
  }

  // Unblock every thread parked in feed()/next_batch()/flush_bucket().
  // Contract for safe teardown with external feeder threads: cancel(),
  // join the feeders (their in-flight feed() returns once stop_ is set),
  // THEN destroy — destroying while a feeder is still inside feed() is a
  // use-after-free.
  void cancel() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
      fed_done_ = true;
    }
    cv_in_.notify_all();
    cv_out_.notify_all();
  }

  void feed(const float* audio, int64_t n_samples, int channels) {
    // the ONE copy of the song on the native side
    auto buf = std::make_shared<const std::vector<float>>(
        audio, audio + n_samples * channels);
    Window song{std::move(buf), 0, channels};
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_in_.wait(lk, [this] { return songs_.size() < 64 || stop_; });
      if (stop_) return;
      songs_.push_back(std::move(song));
    }
    cv_in_.notify_all();
  }

  void finish() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      fed_done_ = true;
    }
    cv_in_.notify_all();
  }

  bool error() const { return error_; }

  // 1 = batch copied, 0 = exhausted
  int next_batch(float* audio_out, int32_t* cat_out, uint8_t* valid_out,
                 int* kind_out, int* n_out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_out_.wait(lk, [this] { return !ready_.empty() || worker_done_ || stop_; });
    if (ready_.empty()) return 0;
    Batch b = std::move(ready_.front());
    ready_.pop_front();
    lk.unlock();
    cv_out_.notify_all();
    std::memcpy(audio_out, b.audio.data(), b.audio.size() * sizeof(float));
    std::memcpy(cat_out, b.category.data(), b.category.size() * sizeof(int32_t));
    std::memcpy(valid_out, b.valid.data(), b.valid.size());
    *kind_out = b.kind;
    *n_out = b.n;
    return 1;
  }

 private:
  void run() {
    while (true) {
      Window song;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_in_.wait(lk, [this] { return !songs_.empty() || fed_done_ || stop_; });
        if (stop_) return;
        if (songs_.empty()) break;  // fed_done_ and queue empty
        song = std::move(songs_.front());
        songs_.pop_front();
      }
      cv_in_.notify_all();
      process_song(std::move(song));
    }
    // drain song shuffle
    if (apa_mode_ == 1) {
      for (Window& s : song_shuffle_.finish()) slice_song(std::move(s));
      for (Window& w : win_shuffle_.finish()) emit_misaligned_tail(std::move(w));
    }
    flush_partial();
    {
      std::lock_guard<std::mutex> lk(mu_);
      worker_done_ = true;
    }
    cv_out_.notify_all();
  }

  void process_song(Window song) {
    if (apa_mode_ == 1) {  // reference mode: shuffle songs first
      Window out;
      if (song_shuffle_.push(std::move(song), &out)) slice_song(std::move(out));
    } else {
      slice_song(std::move(song));
    }
  }

  void slice_song(Window song) {
    int ch = song.channels;
    int64_t n = static_cast<int64_t>(song.src->size()) / ch;
    for (int64_t i = song.offset; i + win_len_ <= n; i += win_len_) {
      emit_window(Window{song.src, i, ch});  // zero-copy view
    }
  }

  void emit_window(Window w) {
    if (apa_mode_ > 0 && w.channels != 2) {
      // mirror serialize_items' shape validation (embed.py:53-56)
      std::lock_guard<std::mutex> lk(mu_);
      error_ = true;
      return;
    }
    if (apa_mode_ > 0) {
      push_pair(w.ptr(), kCatAligned);
      if (apa_mode_ == 1) {
        // tee: the same window (a view — shared_ptr copy) also feeds the
        // misalignment shuffle
        Window out;
        if (win_shuffle_.push(w, &out)) {
          pending_shuffled_.push_back(std::move(out));
          pair_misaligned();
        }
      }
    }
    if (stems_mode_) {
      push_stem(w);
    }
    if (apa_mode_ == 1) {
      // queue this window's context for pairing with a shuffled stem
      ctx_queue_.push_back(std::move(w));
      pair_misaligned();
    }
  }

  void pair_misaligned() {
    while (!ctx_queue_.empty() && !pending_shuffled_.empty()) {
      Window ctx = std::move(ctx_queue_.front());
      ctx_queue_.pop_front();
      Window shuf = std::move(pending_shuffled_.front());
      pending_shuffled_.pop_front();
      push_misaligned(ctx.ptr(), shuf.ptr());
    }
  }

  void emit_misaligned_tail(Window shuf) {
    pending_shuffled_.push_back(std::move(shuf));
    pair_misaligned();
  }

  struct Bucket {
    std::vector<float> audio;
    std::vector<int32_t> category;
    int n = 0;
  };

  // --- bucket writers: windows materialize HERE, directly into the batch
  // buffer (one pass per emitted item; no intermediate window storage) ---

  float* bucket_slot(Bucket& b, int ch) {
    if (b.audio.empty())
      b.audio.resize((size_t)batch_size_ * win_len_ * ch, 0.f);
    return b.audio.data() + (size_t)b.n * win_len_ * ch;
  }

  void seal(Bucket& b, int category, int kind, int ch) {
    b.category.push_back(category);
    ++b.n;
    if (b.n == batch_size_) flush_bucket(b, kind, ch);
  }

  void push_pair(const float* src, int category) {
    std::memcpy(bucket_slot(pair_bucket_, 2), src,
                (size_t)win_len_ * 2 * sizeof(float));
    seal(pair_bucket_, category, kKindPair, 2);
  }

  void push_stem(const Window& w) {
    float* dst = bucket_slot(mono_bucket_, 1);
    if (w.channels == 1) {
      std::memcpy(dst, w.ptr(), (size_t)win_len_ * sizeof(float));
    } else {
      const float* src = w.ptr();
      const int ch = w.channels, last = w.channels - 1;
      for (int i = 0; i < win_len_; ++i) dst[i] = src[i * ch + last];
    }
    seal(mono_bucket_, kCatStem, kKindMono, 1);
  }

  void push_misaligned(const float* ctx, const float* shuf) {
    float* dst = bucket_slot(pair_bucket_, 2);
    for (int i = 0; i < win_len_; ++i) {
      dst[i * 2] = ctx[i * 2];           // context of item1
      dst[i * 2 + 1] = shuf[i * 2 + 1];  // stem of shuffled item
    }
    seal(pair_bucket_, kCatMisaligned, kKindPair, 2);
  }

  void flush_bucket(Bucket& b, int kind, int ch) {
    Batch out;
    out.kind = kind;
    out.n = b.n;
    out.audio = std::move(b.audio);
    out.audio.resize((size_t)batch_size_ * win_len_ * ch, 0.f);
    out.category.assign(batch_size_, 0);
    std::copy(b.category.begin(), b.category.end(), out.category.begin());
    out.valid.assign(batch_size_, 0);
    std::fill(out.valid.begin(), out.valid.begin() + b.n, 1);
    b = Bucket{};
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_out_.wait(lk, [this] {
        return ready_.size() < (size_t)max_ready_ || stop_;
      });
      if (stop_) return;
      ready_.push_back(std::move(out));
    }
    cv_out_.notify_all();
  }

  void flush_partial() {
    if (pair_bucket_.n > 0) flush_bucket(pair_bucket_, kKindPair, 2);
    if (mono_bucket_.n > 0) flush_bucket(mono_bucket_, kKindMono, 1);
  }

  int batch_size_, win_len_, apa_mode_, stems_mode_, max_ready_;
  ShuffleStream<Window> song_shuffle_;
  ShuffleStream<Window> win_shuffle_;
  std::deque<Window> ctx_queue_;
  std::deque<Window> pending_shuffled_;
  Bucket pair_bucket_, mono_bucket_;

  std::mutex mu_;
  std::condition_variable cv_in_, cv_out_;
  std::deque<Window> songs_;
  std::deque<Batch> ready_;
  bool fed_done_ = false;
  bool worker_done_ = false;
  bool stop_ = false;
  bool error_ = false;

  std::thread worker_;
};

}  // namespace

extern "C" {

void* amdl_create(int batch_size, int win_len, int apa_mode, int stems_mode,
                  int song_buffer, int win_buffer, int win_min_age,
                  uint64_t seed, int max_ready_batches) {
  return new Loader(batch_size, win_len, apa_mode, stems_mode, song_buffer,
                    win_buffer, win_min_age, seed, max_ready_batches);
}

void amdl_feed(void* h, const float* audio, int64_t n_samples, int channels) {
  static_cast<Loader*>(h)->feed(audio, n_samples, channels);
}

void amdl_finish(void* h) { static_cast<Loader*>(h)->finish(); }

void amdl_cancel(void* h) { static_cast<Loader*>(h)->cancel(); }

int amdl_next_batch(void* h, float* audio_out, int32_t* cat_out,
                    uint8_t* valid_out, int* kind_out, int* n_out) {
  return static_cast<Loader*>(h)->next_batch(audio_out, cat_out, valid_out,
                                             kind_out, n_out);
}

int amdl_error(void* h) { return static_cast<Loader*>(h)->error() ? 1 : 0; }

void amdl_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
