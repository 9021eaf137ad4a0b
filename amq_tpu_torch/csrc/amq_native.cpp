// amq_native -- the port's host-side native runtime (plain C ABI, ctypes).
//
// Two host hot paths of the serving stack:
//
//  * sub-byte bit packing/unpacking in the pair-planar layout of
//    core/bitpack.py (checkpoint I/O packs ~10^10 weights, where Python
//    packing dominates),
//  * the continuous-batching scheduler (slot allocation, priority
//    admission under a prefill budget, preemption, retirement) driven from
//    the serving loop (serving/engine.py ContinuousBatcher).
//
// Built by native.py with the host C++ compiler (g++ -O3 -fPIC -std=c++17
// -shared) into amq_tpu_torch/_build/ at first use.

#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// bit packing: codes [K, N] row-major uint32 -> words [K*b/32, N]
// layout: per group of g K-rows, planar within the group (see bitpack.py);
// 3-bit = 2-bit plane (code >> 1) followed by 1-bit plane (code & 1).

// pair-planar order (bitpack.py): value at block row p*2R + 2r + h lives
// in word r at bit offset 16*h + b*p (two codes 16 bits apart per round).
static void pack_pow2(const uint32_t* codes, uint32_t* out, int64_t K,
                      int64_t N, int64_t g, int b, int shift_in,
                      uint32_t mask_in, int64_t out_stride_rows) {
  const int64_t rounds = 16 / b;
  const int64_t rows = g * b / 32;  // packed rows per group
  const int64_t G = K / g;
  for (int64_t grp = 0; grp < G; ++grp) {
    const uint32_t* src = codes + grp * g * N;
    uint32_t* dst = out + grp * out_stride_rows * N;
    for (int64_t r = 0; r < rows; ++r) {
      uint32_t* row_out = dst + r * N;
      std::memset(row_out, 0, sizeof(uint32_t) * N);
      for (int64_t p = 0; p < rounds; ++p) {
        for (int64_t h = 0; h < 2; ++h) {
          const int shift = 16 * h + b * p;
          const uint32_t* row_in = src + (p * 2 * rows + 2 * r + h) * N;
          for (int64_t n = 0; n < N; ++n) {
            uint32_t v = (row_in[n] >> shift_in) & mask_in;
            row_out[n] |= v << shift;
          }
        }
      }
    }
  }
}

static void unpack_pow2(const uint32_t* words, uint32_t* out, int64_t K,
                        int64_t N, int64_t g, int b, int shift_out,
                        int64_t in_stride_rows, bool accumulate) {
  const int64_t rounds = 16 / b;
  const int64_t rows = g * b / 32;
  const int64_t G = K / g;
  const uint32_t mask = (1u << b) - 1u;
  for (int64_t grp = 0; grp < G; ++grp) {
    const uint32_t* src = words + grp * in_stride_rows * N;
    uint32_t* dst = out + grp * g * N;
    for (int64_t r = 0; r < rows; ++r) {
      const uint32_t* row_in = src + r * N;
      for (int64_t p = 0; p < rounds; ++p) {
        for (int64_t h = 0; h < 2; ++h) {
          const int shift = 16 * h + b * p;
          uint32_t* row_out = dst + (p * 2 * rows + 2 * r + h) * N;
          if (accumulate) {
            for (int64_t n = 0; n < N; ++n)
              row_out[n] |= ((row_in[n] >> shift) & mask) << shift_out;
          } else {
            for (int64_t n = 0; n < N; ++n)
              row_out[n] = ((row_in[n] >> shift) & mask) << shift_out;
          }
        }
      }
    }
  }
}

// returns 0 on success, -1 on bad arguments
int amq_pack(const uint32_t* codes, uint32_t* out, int64_t K, int64_t N,
             int64_t group_size, int nbits) {
  if (K % group_size != 0) return -1;
  if (nbits == 1 || nbits == 2 || nbits == 4 || nbits == 8) {
    pack_pow2(codes, out, K, N, group_size, nbits, 0, (1u << nbits) - 1u,
              group_size * nbits / 32);
    return 0;
  }
  if (nbits == 3) {
    const int64_t rows3 = group_size * 3 / 32;   // 12 per 128-group
    const int64_t rows2 = group_size * 2 / 32;   // hi plane rows
    // hi plane: (code >> 1) & 3 packed as 2-bit at the group start
    pack_pow2(codes, out, K, N, group_size, 2, 1, 0x3u, rows3);
    // lo plane: (code & 1) packed as 1-bit after the hi rows
    pack_pow2(codes, out + rows2 * N, K, N, group_size, 1, 0, 0x1u, rows3);
    return 0;
  }
  return -1;
}

int amq_unpack(const uint32_t* words, uint32_t* out, int64_t K, int64_t N,
               int64_t group_size, int nbits) {
  if (K % group_size != 0) return -1;
  if (nbits == 1 || nbits == 2 || nbits == 4 || nbits == 8) {
    unpack_pow2(words, out, K, N, group_size, nbits, 0,
                group_size * nbits / 32, false);
    return 0;
  }
  if (nbits == 3) {
    const int64_t rows3 = group_size * 3 / 32;
    const int64_t rows2 = group_size * 2 / 32;
    unpack_pow2(words, out, K, N, group_size, 2, 1, rows3, false);
    unpack_pow2(words + rows2 * N, out, K, N, group_size, 1, 0, rows3, true);
    return 0;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// continuous-batching scheduler
//
//  * priorities -- the queue is kept ordered by (priority desc, admission
//    seq asc); within a priority class service stays FCFS,
//  * chunked-prefill admission -- `fill2` admits requests only while the
//    prompt tokens admitted in THIS call stay within a budget (at least
//    one request is always admitted when a slot is free), bounding the
//    prefill work injected between decode chunks,
//  * preemption -- `preempt` evicts the lowest-priority active slots back
//    to the queue (generated-count preserved; the engine re-prefills
//    prompt + generated on re-admission) for a strictly-higher-priority
//    pending request that no free slot can take.

struct Request {
  int64_t uid;
  int32_t max_new_tokens;
  int32_t generated;
  int32_t priority;     // higher = served first (default 0)
  int32_t prompt_len;   // admission-budget accounting (0 = free)
  int64_t seq;          // submission order, FCFS tiebreak
};

struct Scheduler {
  std::mutex mu;
  std::deque<Request> queue;     // ordered: priority desc, seq asc
  std::vector<Request> slots;    // slot i; uid < 0 => free
  int64_t completed = 0;
  int64_t next_seq = 0;
};

void* amq_sched_create(int32_t n_slots) {
  auto* s = new Scheduler();
  s->slots.assign(n_slots, Request{-1, 0, 0, 0, 0, 0});
  return s;
}

void amq_sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

static void enqueue_ordered(Scheduler* s, Request r) {
  // insert before the first request that should be served after r
  auto it = s->queue.begin();
  while (it != s->queue.end() &&
         (it->priority > r.priority ||
          (it->priority == r.priority && it->seq < r.seq)))
    ++it;
  s->queue.insert(it, r);
}

void amq_sched_submit2(void* h, int64_t uid, int32_t max_new_tokens,
                       int32_t priority, int32_t prompt_len) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  enqueue_ordered(s, Request{uid, max_new_tokens, 0, priority, prompt_len,
                             s->next_seq++});
}

void amq_sched_submit(void* h, int64_t uid, int32_t max_new_tokens) {
  amq_sched_submit2(h, uid, max_new_tokens, 0, 0);
}

// fills free slots from the priority queue while the admitted prompt
// tokens stay within `prefill_budget` (<= 0: uncapped; the first
// admission is always allowed).  Writes filled slot indices/uids;
// returns the count.
int32_t amq_sched_fill2(void* h, int32_t prefill_budget, int32_t* out_slots,
                        int64_t* out_uids, int32_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int32_t n = 0;
  int64_t spent = 0;
  for (size_t i = 0; i < s->slots.size() && n < cap; ++i) {
    if (s->slots[i].uid < 0 && !s->queue.empty()) {
      const Request& head = s->queue.front();
      if (prefill_budget > 0 && n > 0 &&
          spent + head.prompt_len > prefill_budget)
        break;  // next outer iteration (post-decode-chunk) admits it
      spent += head.prompt_len;
      s->slots[i] = head;
      s->queue.pop_front();
      out_slots[n] = static_cast<int32_t>(i);
      out_uids[n] = s->slots[i].uid;
      ++n;
    }
  }
  return n;
}

int32_t amq_sched_fill(void* h, int32_t* out_slots, int64_t* out_uids,
                       int32_t cap) {
  return amq_sched_fill2(h, 0, out_slots, out_uids, cap);
}

// evicts active slots whose priority is strictly below a pending
// request's (lowest priority first, most-recent admission first within a
// priority), one victim per pending request, best-pending first.  The
// first `free` pending requests (free = the slots now empty) are skipped:
// the next fill admits them without evicting anyone.  Victims re-enter
// the queue with generated-count preserved.  Writes (slot, uid,
// generated) per victim; returns the count.
int32_t amq_sched_preempt(void* h, int32_t* out_slots, int64_t* out_uids,
                          int32_t* out_generated, int32_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int32_t n = 0;
  size_t qi = 0;
  for (const Request& r : s->slots) qi += (r.uid < 0);
  while (n < cap && qi < s->queue.size()) {
    const int32_t want = s->queue[qi].priority;
    int victim = -1;
    for (size_t i = 0; i < s->slots.size(); ++i) {
      const Request& r = s->slots[i];
      if (r.uid < 0 || r.priority >= want) continue;
      if (victim < 0 || r.priority < s->slots[victim].priority ||
          (r.priority == s->slots[victim].priority &&
           r.seq > s->slots[victim].seq))
        victim = static_cast<int>(i);
    }
    if (victim < 0) break;  // nothing below this (or any later) priority
    Request r = s->slots[victim];
    s->slots[victim].uid = -1;
    out_slots[n] = victim;
    out_uids[n] = r.uid;
    out_generated[n] = r.generated;
    ++n;
    enqueue_ordered(s, r);  // keeps seq: FCFS position within its class
    ++qi;
  }
  return n;
}

// records one decoded token per active slot; writes retired slot indices,
// returns the number retired.  `mask` (optional, length n_slots) restricts
// the step to mask[i] != 0 slots -- slots mid-chunked-prefill are occupied
// but not decoding, so they must not accrue tokens.
int32_t amq_sched_step2(void* h, const uint8_t* mask, int32_t* retired,
                        int32_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int32_t n = 0;
  for (size_t i = 0; i < s->slots.size(); ++i) {
    Request& r = s->slots[i];
    if (r.uid < 0 || (mask && !mask[i])) continue;
    if (++r.generated >= r.max_new_tokens) {
      if (n < cap) retired[n++] = static_cast<int32_t>(i);
      r.uid = -1;
      ++s->completed;
    }
  }
  return n;
}

int32_t amq_sched_step(void* h, int32_t* retired, int32_t cap) {
  return amq_sched_step2(h, nullptr, retired, cap);
}

int32_t amq_sched_active(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int32_t n = 0;
  for (auto& r : s->slots) n += (r.uid >= 0);
  return n;
}

int64_t amq_sched_pending(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return static_cast<int64_t>(s->queue.size());
}

// records the prefill's first generated token for one slot; returns 1 if
// the request retired (max_new_tokens == 1), 0 if not, -1 for a slot that
// is out of range or empty
int32_t amq_sched_prefill(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  if (slot < 0 || static_cast<size_t>(slot) >= s->slots.size()) return -1;
  Request& r = s->slots[slot];
  if (r.uid < 0) return -1;
  if (++r.generated >= r.max_new_tokens) {
    r.uid = -1;
    ++s->completed;
    return 1;
  }
  return 0;
}

}  // extern "C"
