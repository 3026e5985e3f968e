// Capture loader: pread + deinterleave + ring readahead.
//
// The byte path of a capture file, the counterpart of the reference's
// sample reader (src/samples.rs:44-94).  Numeric decode stays on the
// device (quadrs_tpu_torch.formats); this library does the positional
// reads, turns interleaved component pairs into two contiguous planes,
// and keeps a ring of upcoming chunks filled by reader threads, so that
// disk and deinterleave time overlap the consumer's device work.
//
// Every call that delivers samples writes them straight into memory the
// caller owns (page-locked slots, rows of a bank buffer): the library keeps
// no capture-sized buffer of its own and makes no second copy.  Plain C ABI
// for ctypes.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <fcntl.h>
#include <mutex>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Capture {
  int fd = -1;
  int64_t file_bytes = 0;
  int type_bytes = 1;  // bytes per scalar component

  int64_t pair_bytes() const { return 2 * type_bytes; }
  // a trailing partial pair is not a sample (src/samples.rs:64-66)
  int64_t samples() const { return file_bytes / pair_bytes(); }
};

// Split interleaved component pairs into two contiguous planes.
// __restrict lets the compiler vectorize the stride-2 gather.
template <typename T>
void deinterleave(const T* __restrict src, T* __restrict re, T* __restrict im,
                  int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    re[i] = src[2 * i];
    im[i] = src[2 * i + 1];
  }
}

void deinterleave_any(const uint8_t* src, uint8_t* re, uint8_t* im, int64_t n,
                      int type_bytes) {
  switch (type_bytes) {
    case 1:
      deinterleave<uint8_t>(src, re, im, n);
      break;
    case 2:
      deinterleave<uint16_t>(reinterpret_cast<const uint16_t*>(src),
                             reinterpret_cast<uint16_t*>(re),
                             reinterpret_cast<uint16_t*>(im), n);
      break;
    case 4:
      deinterleave<uint32_t>(reinterpret_cast<const uint32_t*>(src),
                             reinterpret_cast<uint32_t*>(re),
                             reinterpret_cast<uint32_t*>(im), n);
      break;
  }
}

// pread until `bytes` arrived, EOF, or an error; returns bytes read or -1.
int64_t pread_full(int fd, uint8_t* dst, int64_t bytes, int64_t pos) {
  int64_t done = 0;
  while (done < bytes) {
    ssize_t r = pread(fd, dst + done, bytes - done, pos + done);
    if (r < 0) return -1;
    if (r == 0) break;
    done += r;
  }
  return done;
}

// Samples [off, off+want) of the capture as planes at `re`/`im`, read in
// blocks small enough to stay in the cache between the pread that fills
// them and the deinterleave that empties them: no capture-sized scratch.
// Returns samples delivered (short at EOF), -1 on a read error.
constexpr int64_t kBlockBytes = 256 << 10;

int64_t read_deinterleaved(const Capture* cap, int64_t off, int64_t want,
                           void* re, void* im) {
  thread_local std::vector<uint8_t> block(kBlockBytes);
  const int64_t pair = cap->pair_bytes();
  const int64_t per_block = kBlockBytes / pair;
  auto* re8 = static_cast<uint8_t*>(re);
  auto* im8 = static_cast<uint8_t*>(im);
  int64_t got = 0;
  while (got < want) {
    int64_t m = std::min(per_block, want - got);
    int64_t r = pread_full(cap->fd, block.data(), m * pair, (off + got) * pair);
    if (r < 0) return -1;
    int64_t k = r / pair;
    deinterleave_any(block.data(), re8 + got * cap->type_bytes,
                     im8 + got * cap->type_bytes, k, cap->type_bytes);
    got += k;
    if (k < m) break;  // EOF (or a file cut short under us)
  }
  return got;
}

// Readahead: N reader threads fill, in stream order, plane buffers that the
// consumer lends ahead of time (page-locked slots): pread and deinterleave
// scale across cores and land where the consumer wants them, with no copy
// in between.  Each chunk may carry an `overlap` tail re-read from the next
// chunk's head, so the consumer gets its filter lookahead without stitching
// on the host.
struct Prefetcher {
  Capture* cap = nullptr;
  int64_t chunk_samples = 0;
  int64_t overlap_samples = 0;
  int64_t start_off = 0;

  struct Job {
    void* re = nullptr;
    void* im = nullptr;
    int64_t off = -1;
    int64_t n = 0;
    bool filled = false;
  };
  std::vector<Job> jobs;  // a ring indexed by sequence number
  int64_t lent = 0;       // destinations lent so far
  int64_t popped = 0;     // chunks handed back so far
  std::atomic<int64_t> next_seq{0};
  std::mutex mu;
  std::condition_variable cv_lent, cv_filled;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void run() {
    const int64_t cap_jobs = static_cast<int64_t>(jobs.size());
    for (;;) {
      if (stop.load()) return;
      int64_t seq = next_seq.fetch_add(1);
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_lent.wait(lk, [&] { return stop.load() || lent > seq; });
        if (stop.load()) return;
        job = jobs[seq % cap_jobs];
      }
      int64_t off = start_off + seq * chunk_samples;
      int64_t want =
          std::min(chunk_samples + overlap_samples, cap->samples() - off);
      int64_t got = 0;
      if (want > 0) {
        got = read_deinterleaved(cap, off, want, job.re, job.im);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        Job& j = jobs[seq % cap_jobs];
        j.off = off;
        j.n = got;
        j.filled = true;
      }
      cv_filled.notify_all();
      if (got <= 0) return;  // past EOF: the 0-marker is queued in order
    }
  }
};

}  // namespace

extern "C" {

void* qt_open(const char* path, int type_bytes) {
  if (type_bytes != 1 && type_bytes != 2 && type_bytes != 4) return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* cap = new Capture();
  cap->fd = fd;
  cap->file_bytes = st.st_size;
  cap->type_bytes = type_bytes;
  return cap;
}

int64_t qt_samples(void* h) { return static_cast<Capture*>(h)->samples(); }

// Read [off, off+n) samples as planes into caller buffers (native dtype,
// n*type_bytes each).  Returns samples read (short at EOF), -1 on error.
// What lies past the returned count is left as the caller had it.  A read
// of kParallelSamples or more is split over up to four threads.
constexpr int64_t kParallelSamples = 4 << 20;

int64_t qt_read_planes(void* h, int64_t off, int64_t n, void* re, void* im) {
  auto* cap = static_cast<Capture*>(h);
  if (off < 0 || n < 0) return -1;
  int64_t avail = cap->samples() - off;
  if (avail <= 0) return 0;
  const int64_t want = std::min(n, avail);
  const int64_t parts = std::min<int64_t>(4, want / (kParallelSamples / 4));
  if (want < kParallelSamples || parts < 2)
    return read_deinterleaved(cap, off, want, re, im);
  const int64_t each = (want + parts - 1) / parts;
  std::vector<int64_t> got(parts, 0);
  std::vector<std::thread> threads;
  for (int64_t p = 0; p < parts; ++p) {
    threads.emplace_back([=, &got] {
      const int64_t lo = p * each;
      const int64_t m = std::min(each, want - lo);
      got[p] = read_deinterleaved(
          cap, off + lo, m, static_cast<uint8_t*>(re) + lo * cap->type_bytes,
          static_cast<uint8_t*>(im) + lo * cap->type_bytes);
    });
  }
  for (auto& t : threads) t.join();
  int64_t total = 0;
  for (int64_t p = 0; p < parts; ++p) {
    if (got[p] < 0) return -1;
    total += got[p];
    if (got[p] < std::min(each, want - p * each)) break;  // short: what follows is not contiguous
  }
  return total;
}

void qt_close(void* h) {
  auto* cap = static_cast<Capture*>(h);
  close(cap->fd);
  delete cap;
}

// Start a prefetcher over chunks of `chunk_samples` (+ `overlap_samples`)
// from `start_off`.  At most `n_buffers` lent destinations may be
// outstanding (lent and not yet handed back by qt_prefetch_next).
void* qt_prefetch_start(void* h, int64_t chunk_samples, int n_buffers,
                        int64_t start_off, int64_t overlap_samples,
                        int n_workers) {
  if (chunk_samples < 1 || start_off < 0 || overlap_samples < 0) return nullptr;
  auto* p = new Prefetcher();
  p->cap = static_cast<Capture*>(h);
  p->chunk_samples = chunk_samples;
  p->overlap_samples = overlap_samples;
  p->start_off = start_off;
  if (n_workers < 1) n_workers = 1;
  if (n_buffers < 1) n_buffers = 1;
  p->jobs.resize(n_buffers);
  for (int i = 0; i < n_workers; ++i)
    p->workers.emplace_back([p] { p->run(); });
  return p;
}

// Lend the plane buffers of the next chunk in stream order, each at least
// (chunk_samples+overlap_samples)*type_bytes; a reader thread fills them.
// Returns 0, or -1 when n_buffers destinations are outstanding already.
int qt_prefetch_lend(void* ph, void* re, void* im) {
  auto* p = static_cast<Prefetcher*>(ph);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    const int64_t cap_jobs = static_cast<int64_t>(p->jobs.size());
    if (p->lent - p->popped >= cap_jobs) return -1;
    Prefetcher::Job& j = p->jobs[p->lent % cap_jobs];
    j = Prefetcher::Job();
    j.re = re;
    j.im = im;
    ++p->lent;
  }
  p->cv_lent.notify_all();
  return 0;
}

// Wait for the oldest outstanding destination to be filled.  Returns the
// samples delivered into it (0 past EOF, and again on every later call;
// bytes past the count are untouched), -1 when nothing is outstanding,
// -2 when the read failed.
int64_t qt_prefetch_next(void* ph, int64_t* off_out) {
  auto* p = static_cast<Prefetcher*>(ph);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->popped >= p->lent) return -1;
  Prefetcher::Job& j = p->jobs[p->popped % static_cast<int64_t>(p->jobs.size())];
  p->cv_filled.wait(lk, [&] { return j.filled; });
  *off_out = j.off;
  if (j.n < 0) return -2;
  if (j.n > 0) ++p->popped;
  return j.n;
}

// Stop the reader threads and wait for them: once this returns, nothing
// writes into a lent buffer any more.
void qt_prefetch_stop(void* ph) {
  auto* p = static_cast<Prefetcher*>(ph);
  p->stop.store(true);
  {
    // take the lock so no worker is between its predicate and its wait
    std::lock_guard<std::mutex> lk(p->mu);
  }
  p->cv_lent.notify_all();
  p->cv_filled.notify_all();
  for (auto& w : p->workers)
    if (w.joinable()) w.join();
  delete p;
}

}  // extern "C"
