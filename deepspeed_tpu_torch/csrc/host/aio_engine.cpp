// Async file I/O engine — the ZeRO-Infinity NVMe tier.
//
// Role parity with the reference csrc/aio/ [K] (deepspeed_aio_thread.cpp,
// deepspeed_aio_common.cpp, py_lib bindings): an aio_handle with a
// worker-thread pool draining a submission queue of pread/pwrite ops
// against O_DIRECT block files, with wait/drain semantics the swap layer
// builds on (aio_handle(block_size, queue_depth, single_submit,
// overlap_events, thread_count) ctor keys [L ACC-DC:1187-1194]).
//
// O_DIRECT is the defining property (as in the reference): NVMe-tier
// traffic bypasses the page cache, so host memory stays
// O(buffer_count × layer) instead of the kernel caching the whole
// dataset.  User buffers are arbitrary-aligned; each worker owns one
// 4 KiB-aligned bounce buffer and the aligned body of every transfer goes
// O_DIRECT while the (<4 KiB) unaligned tail goes through a plain fd —
// the same split the reference's aligned/unaligned io paths make.
// Filesystems that reject O_DIRECT (tmpfs) degrade to buffered I/O;
// ds_aio_stats reports the byte split so callers/tests can tell.
//
// Config keys honored (reference semantics, thread-pool adaptation):
//   block_size     transfer granularity (rounded up to 4 KiB)
//   queue_depth    max in-flight ops — submit blocks past it (backpressure)
//   single_submit  true: one op stays one queue entry; false (default):
//                  large ops split into block_size sub-ops so several
//                  workers overlap one transfer
//   overlap_events true (default): submit returns immediately; false:
//                  every submit drains before returning
//
// TPU-first adaptation: std::thread pool + p{read,write} with a C ABI for
// ctypes.  (io_uring/libaio would pin this to specific kernels; the pool
// saturates TPU-VM NVMe with queue_depth×thread_count in-flight ops, and
// the interface leaves room to swap the backend.)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kAlign = 4096;  // logical block alignment for O_DIRECT

inline int64_t align_down(int64_t x) { return x & ~(kAlign - 1); }
inline int64_t align_up(int64_t x) { return (x + kAlign - 1) & ~(kAlign - 1); }

struct Op {
  enum Kind { READ, WRITE } kind;
  void* buf;
  int64_t nbytes;
  std::string path;
  int64_t offset;
  bool trunc = false;  // WRITE: ftruncate file to offset+nbytes afterwards
};

struct Handle {
  int64_t block_size;
  int queue_depth;
  int thread_count;
  bool single_submit;
  bool overlap_events;
  std::vector<std::thread> workers;
  std::deque<Op> queue;
  std::mutex mu;
  std::condition_variable cv_submit;
  std::condition_variable cv_done;
  std::atomic<int64_t> inflight{0};
  std::atomic<int64_t> errors{0};
  std::atomic<int64_t> bytes_direct{0};
  std::atomic<int64_t> bytes_buffered{0};
  std::atomic<int64_t> read_retries{0};
  bool shutdown = false;

  void worker() {
    // one aligned bounce buffer per worker, reused for every O_DIRECT op
    void* bounce = nullptr;
    int64_t bounce_cap = 0;
    for (;;) {
      Op op;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_submit.wait(lk, [&] { return shutdown || !queue.empty(); });
        if (shutdown && queue.empty()) break;
        op = queue.front();
        queue.pop_front();
      }
      if (run_one(op, &bounce, &bounce_cap) != 0) errors.fetch_add(1);
      {
        // decrement+notify under the mutex: a lock-free notify can fire
        // between the waiter's predicate check and its sleep (lost wakeup)
        std::lock_guard<std::mutex> lk(mu);
        inflight.fetch_sub(1);
        cv_done.notify_all();  // wait() AND queue_depth backpressure
      }
    }
    std::free(bounce);
  }

  int ensure_bounce(void** bounce, int64_t* cap, int64_t need) {
    if (*cap >= need) return 0;
    std::free(*bounce);
    *bounce = nullptr;
    if (posix_memalign(bounce, kAlign, need) != 0) {
      *cap = 0;
      return -1;
    }
    *cap = need;
    return 0;
  }

  // Transfer [offset, offset+nbytes) of the file through an O_DIRECT fd
  // and a bounce buffer.  Requires offset aligned; nbytes arbitrary (reads
  // may overshoot the request into the bounce buffer — never into `p`).
  int direct_body(int fd, Op::Kind kind, char* p, int64_t nbytes,
                  int64_t offset, void* bounce) {
    int64_t remaining = nbytes;
    int64_t off = offset;
    int64_t chunk = align_up(block_size > 0 ? block_size : (1 << 20));
    while (remaining > 0) {
      int64_t want = remaining < chunk ? remaining : chunk;
      if (kind == Op::READ) {
        // read whole aligned blocks; copy out just the requested bytes.
        // Short transfers are legal (signal/kernel split) — retry from
        // the returned count as long as O_DIRECT alignment holds.
        int64_t need = align_up(want);
        int64_t done = 0;
        while (done < want) {
          ssize_t got = ::pread(fd, (char*)bounce + done, need - done,
                                off + done);
          if (got <= 0) return -1;
          done += got;
          // continuing from an unaligned position would break O_DIRECT;
          // legal only when the request is already satisfied (short final
          // read at an unaligned EOF — buffered tails make those normal)
          if (done < want && done % kAlign) return -1;
        }
        std::memcpy(p, bounce, want);
      } else {
        if (want % kAlign) return -1;  // caller routes tails elsewhere
        std::memcpy(bounce, p, want);
        int64_t done = 0;
        while (done < want) {
          ssize_t put = ::pwrite(fd, (char*)bounce + done, want - done,
                                 off + done);
          if (put <= 0 || put % kAlign) return -1;
          done += put;
        }
      }
      p += want;
      off += want;
      remaining -= want;
    }
    bytes_direct.fetch_add(nbytes);
    return 0;
  }

  // Plain buffered transfer (fallback + unaligned tails).
  int buffered_body(int fd, Op::Kind kind, char* p, int64_t nbytes,
                    int64_t offset) {
    int64_t remaining = nbytes;
    int64_t off = offset;
    int64_t chunk = block_size > 0 ? block_size : (1 << 20);
    while (remaining > 0) {
      int64_t n = remaining < chunk ? remaining : chunk;
      ssize_t done = (kind == Op::READ) ? ::pread(fd, p, n, off)
                                        : ::pwrite(fd, p, n, off);
      if (done <= 0) return -1;
      p += done;
      off += done;
      remaining -= done;
    }
    bytes_buffered.fetch_add(nbytes);
    return 0;
  }

  int run_one(const Op& op, void** bounce, int64_t* bounce_cap) {
    int base = (op.kind == Op::READ) ? O_RDONLY : (O_WRONLY | O_CREAT);
    char* p = (char*)op.buf;
    int rc = 0;

    // O_DIRECT path: aligned offset required (the swapper always starts
    // at 0 / block multiples); aligned BODY via the bounce buffer, then a
    // buffered (<4 KiB) tail.  Writes need the aligned body to be a block
    // multiple; reads may overshoot into the bounce buffer, so the whole
    // length can go direct when the file is long enough.
    int dfd = -1;
    if (op.offset % kAlign == 0) dfd = ::open(op.path.c_str(), base | O_DIRECT, 0644);
    if (dfd >= 0) {
      int64_t chunk = align_up(block_size > 0 ? block_size : (1 << 20));
      if (ensure_bounce(bounce, bounce_cap, chunk) != 0) {
        ::close(dfd);
        return -1;
      }
      int64_t body = align_down(op.nbytes);
      int64_t tail = op.nbytes - body;
      if (op.kind == Op::READ) {
        // only overshoot-read when the file extends past the request
        // (aligned files written by this engine always do)
        struct stat st;
        if (::fstat(dfd, &st) == 0 &&
            st.st_size >= op.offset + align_up(op.nbytes)) {
          body = op.nbytes;
          tail = 0;
        }
      }
      if (body > 0)
        rc = direct_body(dfd, op.kind, p, body, op.offset, *bounce);
      ::close(dfd);
      if (rc != 0 && op.kind == Op::READ) {
        // the overshoot decision was taken at open time; a concurrent
        // whole-file rewrite to the exact logical size (dropping only the
        // alignment overshoot) between fstat and the final pread makes
        // the direct read come up short.  Reads are idempotent — retry
        // the whole request buffered.  A file shrunk below
        // offset+nbytes still fails (buffered_body errors at EOF): the
        // requested bytes genuinely don't exist.  read_retries makes the
        // degradation observable: a direct-path regression (EIO,
        // alignment bug) that this retry would otherwise mask shows up
        // as a climbing counter in ds_aio_stats.
        read_retries.fetch_add(1);
        int rfd = ::open(op.path.c_str(), base, 0644);
        if (rfd < 0) return -1;
        rc = buffered_body(rfd, op.kind, p, op.nbytes, op.offset);
        ::close(rfd);
        return rc;
      }
      if (rc == 0 && tail > 0) {
        int tfd = ::open(op.path.c_str(), base, 0644);
        if (tfd < 0) return -1;
        rc = buffered_body(tfd, op.kind, p + body, tail, op.offset + body);
        ::close(tfd);
      }
    } else {
      // O_DIRECT unavailable (tmpfs, unaligned offset): buffered fallback
      int fd = ::open(op.path.c_str(), base, 0644);
      if (fd < 0) return -1;
      rc = buffered_body(fd, op.kind, p, op.nbytes, op.offset);
      ::close(fd);
    }

    if (rc == 0 && op.kind == Op::WRITE && op.trunc) {
      // whole-file rewrite: drop stale tail bytes from a previous larger
      // shard at the same path.  O_DIRECT writes rounded the file up to
      // block multiples only in the buffered-tail-free case; the truncate
      // also restores the true logical size.
      if (::truncate(op.path.c_str(), op.offset + op.nbytes) != 0) rc = -1;
    }
    return rc;
  }
};

}  // namespace

extern "C" {

void* ds_aio_new(int block_size, int queue_depth, int single_submit,
                 int overlap_events, int thread_count) {
  Handle* h = new Handle();
  h->block_size = block_size;
  h->queue_depth = queue_depth > 0 ? queue_depth : 32;
  h->thread_count = thread_count > 0 ? thread_count : 1;
  h->single_submit = single_submit != 0;
  h->overlap_events = overlap_events != 0;
  for (int i = 0; i < h->thread_count; ++i)
    h->workers.emplace_back([h] { h->worker(); });
  return h;
}

void ds_aio_free(void* hp) {
  Handle* h = (Handle*)hp;
  {
    std::lock_guard<std::mutex> lk(h->mu);
    h->shutdown = true;
  }
  h->cv_submit.notify_all();
  for (auto& t : h->workers) t.join();
  delete h;
}

static void enqueue(Handle* h, Op op) {
  {
    // queue_depth backpressure: the submitter blocks while the engine has
    // queue_depth ops in flight (the reference's AIO context depth)
    std::unique_lock<std::mutex> lk(h->mu);
    h->cv_done.wait(
        lk, [&] { return h->inflight.load() < h->queue_depth; });
    h->inflight.fetch_add(1);
    h->queue.push_back(std::move(op));
  }
  h->cv_submit.notify_one();
}

static void submit(Handle* h, Op op) {
  // single_submit=false (default): split large ops into block_size
  // sub-ops so several workers overlap one transfer — the thread-pool
  // analogue of batched io_submit.  WRITE splits pre-size the file once
  // so sub-writes never race an implicit extend.
  int64_t chunk = h->block_size > 0 ? align_up(h->block_size) : 0;
  bool split = !h->single_submit && chunk > 0 && op.nbytes > chunk &&
               h->thread_count > 1;
  if (split && op.kind == Op::WRITE) {
    int fd = ::open(op.path.c_str(), O_WRONLY | O_CREAT, 0644);
    if (fd < 0) {
      split = false;
    } else {
      if (op.trunc) (void)!::ftruncate(fd, op.offset + op.nbytes);
      ::close(fd);
    }
  }
  if (split) {
    op.trunc = false;  // pre-sized above; sub-writes must not truncate
    for (int64_t off = 0; off < op.nbytes; off += chunk) {
      Op sub = op;
      sub.buf = (char*)op.buf + off;
      sub.offset = op.offset + off;
      sub.nbytes = (op.nbytes - off) < chunk ? (op.nbytes - off) : chunk;
      enqueue(h, std::move(sub));
    }
  } else {
    enqueue(h, std::move(op));
  }
  if (!h->overlap_events) {
    // overlap_events=false: synchronous submits (drain before returning)
    std::unique_lock<std::mutex> lk(h->mu);
    h->cv_done.wait(lk, [&] { return h->inflight.load() == 0; });
  }
}

// async submit; pair with ds_aio_wait
void ds_aio_pread(void* hp, void* buf, int64_t nbytes, const char* path,
                  int64_t offset) {
  submit((Handle*)hp, Op{Op::READ, buf, nbytes, path, offset});
}

void ds_aio_pwrite(void* hp, const void* buf, int64_t nbytes, const char* path,
                   int64_t offset) {
  submit((Handle*)hp, Op{Op::WRITE, (void*)buf, nbytes, path, offset});
}

// write + ftruncate(offset+nbytes): for whole-file shard rewrites
void ds_aio_pwrite_trunc(void* hp, const void* buf, int64_t nbytes,
                         const char* path, int64_t offset) {
  submit((Handle*)hp, Op{Op::WRITE, (void*)buf, nbytes, path, offset, true});
}

// Block until every submitted op completes; returns count of failed ops
// since the last wait (and resets the error counter).
int64_t ds_aio_wait(void* hp) {
  Handle* h = (Handle*)hp;
  std::unique_lock<std::mutex> lk(h->mu);
  h->cv_done.wait(lk, [&] { return h->inflight.load() == 0; });
  return h->errors.exchange(0);
}

int64_t ds_aio_inflight(void* hp) { return ((Handle*)hp)->inflight.load(); }

// Bytes moved through the O_DIRECT path vs the buffered path since handle
// creation — lets callers (and the falsifying test) verify the page cache
// is actually being bypassed.
void ds_aio_stats(void* hp, int64_t* direct_bytes, int64_t* buffered_bytes) {
  Handle* h = (Handle*)hp;
  if (direct_bytes) *direct_bytes = h->bytes_direct.load();
  if (buffered_bytes) *buffered_bytes = h->bytes_buffered.load();
}

// Direct reads that degraded to the buffered fallback (shrink race, or a
// masked direct-path failure) — should stay ~0 in healthy operation.
int64_t ds_aio_read_retries(void* hp) {
  return ((Handle*)hp)->read_retries.load();
}

}  // extern "C"
