// IQ stream loader: mmap'd recorded-IQ capture + slab ring + prefetch thread.
//
// Ring slots store PLANAR I/Q (all I samples, then all Q): captures are
// interleaved pairs on disk (the de-facto SDR layout), but the device consumes
// planar planes (signal/iq.py — de-interleaving on-device is an extra pass
// over the input), so the producer thread
// de-interleaves during the staging copy, hiding the cost off the hot path.
//
// Native analog of the reference's rx hot loop
// (src/extensible_cognitive_radio.cpp:1258-1382): where the reference calls
// usrp->recv() into a per-packet buffer on a dedicated rx worker thread, we
// stage fixed-size blocks of a recorded capture into a single-producer /
// single-consumer ring so the Python host loop that feeds the device never
// blocks on file I/O.  Slab allocation: one contiguous arena for all ring
// slots, allocated once at open (no per-block malloc in the hot path).

#include "crn_runtime.h"

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Slot {
  uint64_t start;   // sample index of first sample in the block
  int64_t n;        // samples in the block (== block_samples), 0 = EOS marker
};

}  // namespace

struct crn_iq_stream {
  int fd = -1;
  const float *map = nullptr;     // mmap'd file: interleaved f32 I/Q
  uint64_t map_bytes = 0;
  uint64_t total_samples = 0;

  uint64_t block_samples = 0;
  uint32_t depth = 0;
  bool loop = false;

  float *arena = nullptr;         // depth * block_samples * 2 floats
  Slot *slots = nullptr;

  // SPSC ring: producer = prefetch thread, consumer = caller.
  std::atomic<uint64_t> head{0};  // next slot to fill (producer)
  std::atomic<uint64_t> tail{0};  // next slot to drain (consumer)
  std::atomic<bool> stop{false};
  std::atomic<bool> done{false};  // producer reached EOS
  std::mutex mu;
  std::condition_variable cv_space, cv_data;

  uint64_t consumed_cursor = 0;   // sample index of next block for caller
  std::thread producer;

  void produce() {
    uint64_t cursor = consumed_cursor;
    while (!stop.load(std::memory_order_acquire)) {
      if (cursor + block_samples > total_samples) {
        if (!loop || total_samples < block_samples) break;
        cursor = 0;  // wrap
      }
      // wait for a free slot
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load(std::memory_order_acquire) ||
                 head.load(std::memory_order_acquire) -
                         tail.load(std::memory_order_acquire) <
                     depth;
        });
      }
      if (stop.load(std::memory_order_acquire)) break;
      uint64_t h = head.load(std::memory_order_relaxed);
      uint32_t idx = static_cast<uint32_t>(h % depth);
      // staging copy + de-interleave: slot = [I x block][Q x block]
      float *slot_i = arena + static_cast<uint64_t>(idx) * block_samples * 2;
      float *slot_q = slot_i + block_samples;
      const float *src = map + cursor * 2;
      for (uint64_t s2 = 0; s2 < block_samples; s2++) {
        slot_i[s2] = src[2 * s2];
        slot_q[s2] = src[2 * s2 + 1];
      }
      slots[idx].start = cursor;
      slots[idx].n = static_cast<int64_t>(block_samples);
      cursor += block_samples;
      // Publish under mu: a store+notify outside the mutex can land between
      // a waiter's predicate check and its sleep (classic lost wakeup) —
      // the consumer would then block in next_slot forever.
      {
        std::lock_guard<std::mutex> lk(mu);
        head.store(h + 1, std::memory_order_release);
      }
      cv_data.notify_one();
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      done.store(true, std::memory_order_release);
    }
    cv_data.notify_all();
  }
};

extern "C" {

crn_iq_stream *crn_iq_open(const char *path, uint64_t block_samples,
                           uint32_t depth, uint64_t start_sample, int loop) {
  if (block_samples == 0 || depth == 0) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    ::close(fd);
    return nullptr;
  }
  auto *s = new crn_iq_stream();
  s->fd = fd;
  s->map_bytes = static_cast<uint64_t>(st.st_size);
  s->total_samples = s->map_bytes / (2 * sizeof(float));
  void *m = mmap(nullptr, s->map_bytes, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) {
    ::close(fd);
    delete s;
    return nullptr;
  }
  madvise(m, s->map_bytes, MADV_SEQUENTIAL);
  s->map = static_cast<const float *>(m);
  s->block_samples = block_samples;
  s->depth = depth;
  s->loop = loop != 0;
  s->consumed_cursor = start_sample;
  s->arena = new float[static_cast<uint64_t>(depth) * block_samples * 2];
  s->slots = new Slot[depth];
  s->producer = std::thread([s] { s->produce(); });
  return s;
}

namespace {

// Pop the next ready slot index, or -1 at end of stream.
int64_t next_slot(crn_iq_stream *s) {
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_data.wait(lk, [&] {
    return s->head.load(std::memory_order_acquire) >
               s->tail.load(std::memory_order_acquire) ||
           s->done.load(std::memory_order_acquire);
  });
  uint64_t t = s->tail.load(std::memory_order_relaxed);
  if (s->head.load(std::memory_order_acquire) <= t) return -1;  // EOS
  return static_cast<int64_t>(t);
}

void release_slot(crn_iq_stream *s, uint64_t t, uint32_t idx) {
  s->consumed_cursor =
      s->slots[idx].start + static_cast<uint64_t>(s->slots[idx].n);
  // Same lost-wakeup discipline as produce(): publish tail under mu so the
  // producer's cv_space predicate can't miss it (with depth==1 the producer
  // and consumer would otherwise mutually deadlock).
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->tail.store(t + 1, std::memory_order_release);
  }
  s->cv_space.notify_one();
}

}  // namespace

int64_t crn_iq_next(crn_iq_stream *s, float *out) {
  if (!s || !out) return -1;
  int64_t t64 = next_slot(s);
  if (t64 < 0) return 0;
  uint64_t t = static_cast<uint64_t>(t64);
  uint32_t idx = static_cast<uint32_t>(t % s->depth);
  int64_t n = s->slots[idx].n;
  // re-interleave from the planar slot (compat layout)
  const float *slot_i =
      s->arena + static_cast<uint64_t>(idx) * s->block_samples * 2;
  const float *slot_q = slot_i + s->block_samples;
  for (int64_t k = 0; k < n; k++) {
    out[2 * k] = slot_i[k];
    out[2 * k + 1] = slot_q[k];
  }
  release_slot(s, t, idx);
  return n;
}

int64_t crn_iq_next_planar(crn_iq_stream *s, float *out_i, float *out_q) {
  if (!s || !out_i || !out_q) return -1;
  int64_t t64 = next_slot(s);
  if (t64 < 0) return 0;
  uint64_t t = static_cast<uint64_t>(t64);
  uint32_t idx = static_cast<uint32_t>(t % s->depth);
  int64_t n = s->slots[idx].n;
  const float *slot_i =
      s->arena + static_cast<uint64_t>(idx) * s->block_samples * 2;
  std::memcpy(out_i, slot_i, static_cast<uint64_t>(n) * sizeof(float));
  std::memcpy(out_q, slot_i + s->block_samples,
              static_cast<uint64_t>(n) * sizeof(float));
  release_slot(s, t, idx);
  return n;
}

uint64_t crn_iq_cursor(const crn_iq_stream *s) {
  return s ? s->consumed_cursor : 0;
}

uint64_t crn_iq_num_samples(const crn_iq_stream *s) {
  return s ? s->total_samples : 0;
}

void crn_iq_close(crn_iq_stream *s) {
  if (!s) return;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop.store(true, std::memory_order_release);
  }
  s->cv_space.notify_all();
  s->cv_data.notify_all();
  if (s->producer.joinable()) s->producer.join();
  if (s->map) munmap(const_cast<float *>(s->map), s->map_bytes);
  if (s->fd >= 0) ::close(s->fd);
  delete[] s->arena;
  delete[] s->slots;
  delete s;
}

}  // extern "C"
