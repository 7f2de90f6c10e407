// Native data-loader: tokenized-corpus batch collation with background
// prefetch.
//
// Native runtime counterpart of the reference's host-side data path
// (project/run_machine_translation.py:90-161 collate_batch — a per-example
// Python loop that pads/shifts/masks on the critical path of every training
// step).  Here the collate runs in C++ over a pre-tokenized corpus that is
// registered once, with a worker thread building the next batch while the
// device computes the current one (double-buffered ring, mirroring the
// device-side double-buffering pattern of the Pallas kernels).
//
// Exposed extern "C" for ctypes — the same binding style the reference uses
// for its CUDA launchers (minitorch/cuda_kernel_ops.py:26-29).
//
// Batch format (identical to the Python collate):
//   token_ids  = src_ids + tgt_ids, truncated to max_len, padded with pad_id
//   input_ids  = token_ids[:-1]
//   labels     = token_ids[1:]
//   weights    = 1.0 on target-token label positions, else 0.0
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Example {
  std::vector<int32_t> src;
  std::vector<int32_t> tgt;
};

struct Batch {
  std::vector<int32_t> input_ids;   // (batch, max_len - 1)
  std::vector<int32_t> labels;      // (batch, max_len - 1)
  std::vector<float> weights;       // (batch, max_len - 1)
};

struct Loader {
  std::vector<Example> corpus;
  int32_t pad_id = 0;
  int max_len = 0;
  int batch_size = 0;

  // epoch sampling state
  std::vector<uint32_t> order;
  size_t cursor = 0;
  std::mt19937 rng;

  // double-buffered prefetch
  Batch buffers[2];
  int ready_slot = -1;       // slot holding a consumable batch
  bool stop = false;
  bool want = false;         // a prefetch has been requested
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;

  void collate_into(Batch& out) {
    const int width = max_len - 1;
    out.input_ids.assign((size_t)batch_size * width, pad_id);
    out.labels.assign((size_t)batch_size * width, pad_id);
    out.weights.assign((size_t)batch_size * width, 0.0f);

    for (int b = 0; b < batch_size; ++b) {
      if (cursor >= order.size()) {
        std::shuffle(order.begin(), order.end(), rng);
        cursor = 0;
      }
      const Example& ex = corpus[order[cursor++]];
      const int n_src = (int)ex.src.size();
      const int n_all = std::min<int>(max_len, n_src + (int)ex.tgt.size());

      // token_ids = src + tgt (truncated), then shift into inputs/labels.
      std::vector<int32_t> ids((size_t)n_all);
      for (int i = 0; i < n_all; ++i)
        ids[(size_t)i] = i < n_src ? ex.src[(size_t)i] : ex.tgt[(size_t)(i - n_src)];

      int32_t* in_row = &out.input_ids[(size_t)b * width];
      int32_t* lb_row = &out.labels[(size_t)b * width];
      float* w_row = &out.weights[(size_t)b * width];
      for (int i = 0; i < width; ++i) {
        if (i < n_all) in_row[i] = ids[(size_t)i];
        if (i + 1 < n_all) {
          lb_row[i] = ids[(size_t)i + 1];
          // label position i predicts token i+1: target token iff i+1 >= n_src
          w_row[i] = (i + 1 >= n_src) ? 1.0f : 0.0f;
        }
      }
      // remaining slots keep pad_id / weight 0 from the assign() fill
    }
  }

  void worker_loop() {
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      cv.wait(lk, [&] { return stop || want; });
      if (stop) return;
      want = false;
      int slot = (ready_slot + 1) & 1;
      lk.unlock();
      collate_into(buffers[slot]);
      lk.lock();
      ready_slot = slot;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Create a loader over a flattened ragged corpus:
//   flat: all src ids of example 0, tgt ids of example 0, src of 1, ...
//   src_lens / tgt_lens: per-example lengths (n_examples each)
void* loader_create(const int32_t* flat, const int32_t* src_lens,
                    const int32_t* tgt_lens, int64_t n_examples,
                    int32_t pad_id, int32_t max_len, int32_t batch_size,
                    uint64_t seed) {
  auto* L = new Loader();
  L->pad_id = pad_id;
  L->max_len = max_len;
  L->batch_size = batch_size;
  L->rng.seed(seed);
  L->corpus.resize((size_t)n_examples);
  const int32_t* p = flat;
  for (int64_t i = 0; i < n_examples; ++i) {
    Example& ex = L->corpus[(size_t)i];
    ex.src.assign(p, p + src_lens[i]);
    p += src_lens[i];
    ex.tgt.assign(p, p + tgt_lens[i]);
    p += tgt_lens[i];
  }
  L->order.resize((size_t)n_examples);
  for (size_t i = 0; i < L->order.size(); ++i) L->order[i] = (uint32_t)i;
  std::shuffle(L->order.begin(), L->order.end(), L->rng);

  L->worker = std::thread([L] { L->worker_loop(); });
  // kick off the first prefetch
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->want = true;
  }
  L->cv.notify_all();
  return L;
}

// Copy the next (prefetched) batch into caller buffers, then start
// prefetching the following one.  Buffer sizes: batch_size * (max_len - 1).
void loader_next(void* handle, int32_t* input_ids, int32_t* labels,
                 float* weights) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv.wait(lk, [&] { return L->ready_slot >= 0; });
  Batch& b = L->buffers[L->ready_slot];
  std::memcpy(input_ids, b.input_ids.data(),
              b.input_ids.size() * sizeof(int32_t));
  std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(int32_t));
  std::memcpy(weights, b.weights.data(), b.weights.size() * sizeof(float));
  L->ready_slot = -1;
  L->want = true;
  lk.unlock();
  L->cv.notify_all();
}

int64_t loader_corpus_size(void* handle) {
  return (int64_t)static_cast<Loader*>(handle)->corpus.size();
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv.notify_all();
  L->worker.join();
  delete L;
}

}  // extern "C"
