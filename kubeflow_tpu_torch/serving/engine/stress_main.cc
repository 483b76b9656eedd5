// Concurrent stress driver for the engine core (core.cc), built with
// sanitizers: the TPU rebuild's stand-in for upstream's `go test -race` CI
// lane (SURVEY.md §5 — the reference has no first-party C++; ours must prove
// its locking under TSAN/ASAN, not just pass single-threaded unit tests).
//
// Build + run (tests/test_engine.py::test_core_concurrent_stress_under_sanitizers):
//   make stress-tsan  (Makefile in this directory)
//
// Scenario: submitter threads race the decode thread across the full API —
// submit (with prefix hashes) / admit / commit / release-with-cache /
// snapshot readers — long enough for every lock-order mistake to surface.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <thread>
#include <vector>

extern "C" {
struct Engine;
Engine* eng_create(int32_t, int32_t, int32_t, int32_t);
void eng_destroy(Engine*);
int32_t eng_submit(Engine*, int64_t, int32_t, int32_t, const uint64_t*, int32_t);
int32_t eng_admit(Engine*, int64_t*, int32_t*, int32_t*, int32_t*);
int32_t eng_commit_token(Engine*, int32_t, int32_t);
void eng_release_cached(Engine*, int32_t, const uint64_t*, int32_t);
void eng_page_table(Engine*, int32_t*);
void eng_seq_lens(Engine*, int32_t*);
void eng_active_mask(Engine*, int32_t*);
int32_t eng_num_free_pages(Engine*);
int32_t eng_queue_depth(Engine*);
int32_t eng_num_active(Engine*);
void eng_cache_stats(Engine*, int64_t*);
int32_t eng_reclaimable(Engine*);
int32_t eng_reclaimable_slow(Engine*);
}

namespace {
constexpr int32_t kSlots = 4;
constexpr int32_t kPages = 65;
constexpr int32_t kPageSize = 8;
constexpr int32_t kMaxPagesPerSlot = 8;
constexpr int kRequests = 2000;

std::atomic<int64_t> next_id{1};
std::atomic<int64_t> completed{0};
std::atomic<bool> done{false};
}  // namespace

static void submitter(Engine* e, unsigned seed) {
  for (int i = 0; i < kRequests; ++i) {
    int64_t id = next_id.fetch_add(1);
    // a handful of shared prefixes so the cache path gets real contention
    uint64_t base = 100 + (seed + i) % 4;
    uint64_t hashes[3] = {base, base * 31 + 7, base * 977 + 13};
    int32_t prompt = 9 + static_cast<int32_t>((seed + i) % 20);
    while (eng_submit(e, id, prompt, 1 + (i % 6), hashes,
                      (prompt - 1) / kPageSize) != 0) {
      std::this_thread::yield();
    }
    // back-pressure: keep the queue bounded so admission keeps up
    while (eng_queue_depth(e) > 64) std::this_thread::yield();
  }
}

static void decoder(Engine* e) {
  std::vector<int32_t> table(kSlots * kMaxPagesPerSlot);
  std::vector<int32_t> lens(kSlots);
  std::vector<int32_t> active(kSlots);
  uint64_t hashes[3];
  while (!done.load()) {
    int64_t rid;
    int32_t plen, mnew, cached;
    while (true) {
      int32_t slot = eng_admit(e, &rid, &plen, &mnew, &cached);
      if (slot < 0) break;
      (void)cached;
    }
    eng_page_table(e, table.data());
    eng_seq_lens(e, lens.data());
    eng_active_mask(e, active.data());
    for (int32_t s = 0; s < kSlots; ++s) {
      if (!active[s]) continue;
      int32_t rc = eng_commit_token(e, s, 0);
      if (rc != 1) {
        uint64_t base = 100 + static_cast<uint64_t>(lens[s]) % 4;
        hashes[0] = base;
        hashes[1] = base * 31 + 7;
        hashes[2] = base * 977 + 13;
        eng_release_cached(e, s, hashes, lens[s] / kPageSize > 3 ? 3 : lens[s] / kPageSize);
        completed.fetch_add(1);
      }
    }
  }
}

static void snapshotter(Engine* e) {
  int64_t stats[4];
  std::vector<int32_t> table(kSlots * kMaxPagesPerSlot);
  while (!done.load()) {
    eng_cache_stats(e, stats);
    eng_page_table(e, table.data());
    (void)eng_num_free_pages(e);
    (void)eng_num_active(e);
    std::this_thread::yield();
  }
}

// The incremental reclaimable counter must never drift from the O(cache)
// recompute.  Checked single-threaded (after the drain) — the two calls take
// the lock separately, so comparing them mid-race would be meaningless.
static bool reclaimable_consistent(Engine* e) {
  int32_t fast = eng_reclaimable(e);
  int32_t slow = eng_reclaimable_slow(e);
  if (fast != slow) {
    std::fprintf(stderr, "reclaimable drift: incremental %d vs recompute %d\n",
                 fast, slow);
    return false;
  }
  return true;
}

int main() {
  Engine* e = eng_create(kSlots, kPages, kPageSize, kMaxPagesPerSlot);
  if (!e) {
    std::fprintf(stderr, "eng_create failed\n");
    return 2;
  }
  std::thread dec(decoder, e);
  std::thread snap(snapshotter, e);
  std::vector<std::thread> subs;
  for (unsigned t = 0; t < 3; ++t) subs.emplace_back(submitter, e, t * 7919);
  for (auto& t : subs) t.join();
  // drain: every submitted request must complete (generous deadline — TSAN
  // slows everything down ~10x and this box may have one core)
  const int64_t want = 3 * kRequests;
  for (int spin = 0; spin < 1200 && completed.load() < want; ++spin) {
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
  }
  done.store(true);
  dec.join();
  snap.join();
  int64_t got = completed.load();
  bool consistent = reclaimable_consistent(e);
  eng_destroy(e);
  if (!consistent) return 1;
  if (got != want) {
    std::fprintf(stderr, "stress: completed %lld of %lld\n",
                 static_cast<long long>(got), static_cast<long long>(want));
    return 1;
  }
  std::printf("stress OK: %lld requests\n", static_cast<long long>(got));
  return 0;
}
