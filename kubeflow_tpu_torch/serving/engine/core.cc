// Continuous-batching engine core: request queue, slot scheduler, paged-KV
// allocator.  C ABI for ctypes (this image has no pybind11).
//
// Role in the stack (SURVEY.md §2b): the TPU-native replacement for the
// reference stack's Triton C++ serving core — "request queue / batcher /
// KV-paging in C++ with JAX compute".  The Python side (engine.py) owns the
// JAX prefill/decode; this core owns admission, slot lifecycle and KV page
// accounting, and is safe to call from server threads (one mutex, no
// allocation on the hot path).
//
// Memory model: a fixed pool of `num_pages` KV pages of `page_size` tokens.
// Each active slot holds ceil(seq_len / page_size) pages, capped at
// max_pages_per_slot.  Admission is all-or-nothing: a request enters a slot
// only if its whole prompt fits in free pages (decode growth may still hit
// OOM; commit_token reports it so the scheduler can preempt).
//
// Prefix cache (vLLM/JetStream-style, allocator-level): full prompt pages
// are refcounted and indexed by a chain hash supplied by the caller
// (hash(page i) folds in hash(page i-1), so equal hashes mean equal
// token prefixes at equal positions).  On submit, the longest cached chain
// prefix is pinned for the request; on admit the slot adopts those pages
// and allocates only the remainder; on release the slot's full prompt
// pages are inserted into the cache instead of freed.  Cached pages with no
// other owner are reclaimed leaf-first by LRU when the free list runs dry,
// so the cache can never cause an admission failure that an empty cache
// would not also have had.

#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
  int64_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
  // chain hashes of the lookup-eligible full prompt pages; the cache lookup
  // happens at ADMIT time (pinning at submit could deadlock head-of-line
  // admission: a pinned page is neither free nor evictable, and the pinning
  // request may sit behind one that needs those very pages)
  std::vector<uint64_t> hashes;
};

struct Slot {
  bool active = false;
  int64_t req_id = -1;
  int32_t seq_len = 0;        // tokens currently in KV (prompt + generated)
  int32_t generated = 0;
  int32_t max_new_tokens = 0;
  std::vector<int32_t> pages; // page ids owned by this slot
};

struct CacheEntry {
  int32_t page;
  uint64_t parent;     // chain hash of the previous page (0 = root)
  int32_t children;    // live cache entries whose parent is this hash
  uint64_t last_use;   // LRU clock
  // Incremental eviction accounting (replaces the per-admit O(cache) rescan):
  // blockers = (this page has a non-cache owner ? 1 : 0) + number of DIRECT
  // children that are themselves blocked.  blockers == 0 iff leaf-first
  // eviction could eventually reclaim this entry; maintained on every
  // ref/deref/insert/erase transition by add_blocker/remove_blocker.
  int32_t blockers;
  uint64_t filed;      // key this entry holds in Engine::evictable (0 = none)
};

struct Engine {
  std::mutex mu;
  int32_t max_slots;
  int32_t num_pages;
  int32_t page_size;
  int32_t max_pages_per_slot;
  std::deque<Request> queue;
  std::vector<Slot> slots;
  std::vector<int32_t> free_pages;  // LIFO free list (refcount 0 pages)
  std::vector<int32_t> refcount;    // per-page owners (slots + pins + cache)
  std::unordered_map<uint64_t, CacheEntry> cache;  // chain hash -> page
  std::vector<uint64_t> page_hash;  // page id -> cache hash (0 = not cached)
  // evictable leaves ordered by LRU clock (last_use is unique per touch), so
  // evict_one is O(log n) and the admit-time reclaimable count is O(1)
  std::map<uint64_t, uint64_t> evictable;  // last_use -> chain hash
  int64_t blocked_count = 0;        // cache entries with blockers > 0
  uint64_t clock = 0;
  int64_t cache_hits = 0;       // pages served from cache
  int64_t cache_misses = 0;     // prompt pages that had to be computed
  int64_t cache_evictions = 0;  // cached pages reclaimed under pressure
  int64_t total_admitted = 0;
  int64_t total_completed = 0;
};

int32_t pages_needed(const Engine* e, int32_t tokens) {
  return (tokens + e->page_size - 1) / e->page_size;
}

// Sync one entry's membership in the evictable-leaf LRU index after any
// mutation of its children/blockers/last_use.
void update_evictable(Engine* e, uint64_t h, CacheEntry& ce) {
  bool eligible = ce.children == 0 && ce.blockers == 0;
  if (eligible) {
    if (ce.filed != ce.last_use) {
      if (ce.filed) e->evictable.erase(ce.filed);
      e->evictable[ce.last_use] = h;
      ce.filed = ce.last_use;
    }
  } else if (ce.filed) {
    e->evictable.erase(ce.filed);
    ce.filed = 0;
  }
}

// An entry became blocked-from-below (own page gained a non-cache owner, or
// a direct child flipped to blocked): bump blockers up the chain, stopping
// at the first ancestor that was already blocked.
void add_blocker(Engine* e, uint64_t h) {
  while (h != 0) {
    auto it = e->cache.find(h);
    if (it == e->cache.end()) return;
    CacheEntry& ce = it->second;
    ce.blockers++;
    update_evictable(e, h, ce);
    if (ce.blockers > 1) return;  // already blocked: ancestors already count it
    e->blocked_count++;
    h = ce.parent;
  }
}

void remove_blocker(Engine* e, uint64_t h) {
  while (h != 0) {
    auto it = e->cache.find(h);
    if (it == e->cache.end()) return;
    CacheEntry& ce = it->second;
    ce.blockers--;
    update_evictable(e, h, ce);
    if (ce.blockers > 0) return;  // still blocked: ancestors keep counting it
    e->blocked_count--;
    h = ce.parent;
  }
}

// All refcount transitions of potentially-cached pages go through these two
// so the blocker accounting can never drift from the refcounts.
void ref_page(Engine* e, int32_t page) {
  if (++e->refcount[page] == 2 && e->page_hash[page] != 0)
    add_blocker(e, e->page_hash[page]);  // first non-cache owner appeared
}

void deref_page(Engine* e, int32_t page) {
  if (--e->refcount[page] == 1 && e->page_hash[page] != 0)
    remove_blocker(e, e->page_hash[page]);  // only the cache's ref remains
  if (e->refcount[page] == 0) e->free_pages.push_back(page);
}

// Drop the LRU evictable cache entry (a leaf whose page has no owner but the
// cache itself).  Returns true if a page was freed.  O(log cache).
bool evict_one(Engine* e) {
  if (e->evictable.empty()) return false;
  auto it = e->evictable.begin();
  uint64_t h = it->second;
  CacheEntry ce = e->cache[h];
  e->evictable.erase(it);
  e->cache.erase(h);
  if (ce.parent != 0) {
    auto pit = e->cache.find(ce.parent);
    if (pit != e->cache.end()) {
      pit->second.children--;
      update_evictable(e, ce.parent, pit->second);
    }
  }
  e->page_hash[ce.page] = 0;
  e->refcount[ce.page] = 0;
  e->free_pages.push_back(ce.page);
  e->cache_evictions++;
  return true;
}

// Pop a free page, evicting cache leaves if needed. -1 if truly exhausted.
int32_t take_page(Engine* e) {
  if (e->free_pages.empty() && !evict_one(e)) return -1;
  int32_t p = e->free_pages.back();
  e->free_pages.pop_back();
  e->refcount[p] = 1;
  return p;
}

// How many cached pages leaf-first eviction could eventually reclaim: an
// entry is reclaimable iff neither it nor any descendant has an owner other
// than the cache.  O(1) via the incremental blocker accounting; the O(cache)
// recompute survives as eng_reclaimable_slow for invariant checks.
int32_t count_reclaimable(Engine* e) {
  return static_cast<int32_t>(e->cache.size()) -
         static_cast<int32_t>(e->blocked_count);
}

int32_t count_reclaimable_slow(Engine* e) {
  std::unordered_map<uint64_t, bool> blocked;
  for (const auto& it : e->cache) {
    if (e->refcount[it.second.page] > 1) {
      uint64_t h = it.first;
      while (h != 0) {
        if (blocked.count(h)) break;  // ancestors above are already marked
        blocked[h] = true;
        auto pit = e->cache.find(h);
        if (pit == e->cache.end()) break;
        h = pit->second.parent;
      }
    }
  }
  int32_t n = 0;
  for (const auto& it : e->cache)
    if (!blocked.count(it.first)) n++;
  return n;
}

}  // namespace

extern "C" {

Engine* eng_create(int32_t max_slots, int32_t num_pages, int32_t page_size,
                   int32_t max_pages_per_slot) {
  if (max_slots <= 0 || num_pages <= 0 || page_size <= 0 ||
      max_pages_per_slot <= 0)
    return nullptr;
  Engine* e = new Engine();
  e->max_slots = max_slots;
  e->num_pages = num_pages;
  e->page_size = page_size;
  e->max_pages_per_slot = max_pages_per_slot;
  e->slots.resize(max_slots);
  // Page 0 is RESERVED as the trash page and never allocated: the fused
  // decode step writes every slot's current-token KV unconditionally (static
  // shapes), and inactive/padded slots point at page 0 — reserving it makes
  // those writes harmless by construction.  Usable capacity: num_pages - 1.
  e->free_pages.reserve(num_pages - 1);
  for (int32_t p = num_pages - 1; p >= 1; --p) e->free_pages.push_back(p);
  e->refcount.assign(num_pages, 0);
  e->refcount[0] = 1;  // the trash page is permanently owned
  e->page_hash.assign(num_pages, 0);
  return e;
}

void eng_destroy(Engine* e) { delete e; }

// Enqueue a request. `hashes` (may be null) are chain hashes for the
// request's lookup-eligible full prompt pages, consulted at admit time.
// Returns 0, or -1 if the prompt can never fit.
int32_t eng_submit(Engine* e, int64_t req_id, int32_t prompt_len,
                   int32_t max_new_tokens, const uint64_t* hashes,
                   int32_t n_hashes) {
  std::lock_guard<std::mutex> lock(e->mu);
  // Admission is head-of-line: a request that exceeds either the per-slot cap
  // OR the whole page pool would block the queue forever — reject it here.
  if (pages_needed(e, prompt_len + max_new_tokens) > e->max_pages_per_slot ||
      pages_needed(e, prompt_len) >= e->num_pages)  // page 0 is reserved
    return -1;
  Request r{req_id, prompt_len, max_new_tokens, {}};
  if (hashes && n_hashes > 0) r.hashes.assign(hashes, hashes + n_hashes);
  e->queue.push_back(std::move(r));
  return 0;
}

// Admit the head-of-line request into a free slot if its prompt fits in free
// (or cache-evictable) pages.  Returns the slot id (prompt pages allocated,
// cache-hit prefix adopted) or -1; *out_cached = adopted page count.
int32_t eng_admit(Engine* e, int64_t* out_req_id, int32_t* out_prompt_len,
                  int32_t* out_max_new, int32_t* out_cached) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (out_cached) *out_cached = 0;
  if (e->queue.empty()) return -1;
  int32_t slot_id = -1;
  for (int32_t s = 0; s < e->max_slots; ++s)
    if (!e->slots[s].active) { slot_id = s; break; }
  if (slot_id < 0) return -1;
  Request& r = e->queue.front();
  // longest cached chain prefix; take refs so these pages are neither free
  // nor counted reclaimable below
  std::vector<int32_t> pages;
  for (uint64_t h : r.hashes) {
    auto it = e->cache.find(h);
    if (it == e->cache.end()) break;
    it->second.last_use = ++e->clock;
    // ref_page makes the entry blocked (refcount >= 2), which unfiles it
    // from the evictable index; the LRU touch lands when the last external
    // ref drops (deref_page -> remove_blocker -> update_evictable refiles
    // under the new last_use)
    ref_page(e, it->second.page);
    pages.push_back(it->second.page);
  }
  int32_t cached = static_cast<int32_t>(pages.size());
  int32_t need = pages_needed(e, r.prompt_len);
  int32_t need_new = need - cached;
  if (need_new > static_cast<int32_t>(e->free_pages.size()) + count_reclaimable(e)) {
    // cannot fit yet: undo the hit refs (pages stay cached) and leave the
    // request queued — deciding BEFORE evicting keeps a failed attempt from
    // wiping the evictable cache
    for (int32_t p : pages) deref_page(e, p);
    return -1;
  }
  for (int32_t i = 0; i < need_new; ++i) {
    int32_t p = take_page(e);
    if (p < 0) {  // unreachable per the check above; fail closed regardless
      for (int32_t q : pages) deref_page(e, q);
      return -1;
    }
    pages.push_back(p);
  }
  e->cache_hits += cached;
  e->cache_misses += need_new;
  Slot& slot = e->slots[slot_id];
  slot.active = true;
  slot.req_id = r.id;
  slot.seq_len = r.prompt_len;
  slot.generated = 0;
  slot.max_new_tokens = r.max_new_tokens;
  slot.pages = std::move(pages);
  *out_req_id = r.id;
  *out_prompt_len = r.prompt_len;
  *out_max_new = r.max_new_tokens;
  if (out_cached) *out_cached = cached;
  e->queue.pop_front();
  e->total_admitted++;
  return slot_id;
}

// Record one generated token for a slot, growing its KV by one position.
// Returns 1 = keep decoding, 0 = request finished (eos or budget),
// -2 = page pool exhausted (caller should preempt/release), -1 = bad slot.
// *out_new_page (may be null) reports the page id allocated by this commit,
// or -1 — the caller can mirror the page table incrementally instead of
// re-snapshotting max_slots x max_pages ints from C every tick.
int32_t eng_commit_token_ex(Engine* e, int32_t slot_id, int32_t is_eos,
                            int32_t* out_new_page) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (out_new_page) *out_new_page = -1;
  if (slot_id < 0 || slot_id >= e->max_slots) return -1;
  Slot& slot = e->slots[slot_id];
  if (!slot.active) return -1;
  int32_t need = pages_needed(e, slot.seq_len + 1);
  if (need > static_cast<int32_t>(slot.pages.size())) {
    if (need > e->max_pages_per_slot) return 0;  // hit the per-slot cap: done
    int32_t p = take_page(e);  // evicts cache leaves before giving up
    if (p < 0) return -2;
    slot.pages.push_back(p);
    if (out_new_page) *out_new_page = p;
  }
  slot.seq_len++;
  slot.generated++;
  if (is_eos || slot.generated >= slot.max_new_tokens) return 0;
  return 1;
}

int32_t eng_commit_token(Engine* e, int32_t slot_id, int32_t is_eos) {
  return eng_commit_token_ex(e, slot_id, is_eos, nullptr);
}

// Pre-allocate one more KV page for an active slot.  Speculative drafting
// needs every draft row's KV position inside OWNED pages, so near a page
// boundary the drafter reserves the next page before proposing past it
// (otherwise drafts clamp to the room left and boundary ticks degrade to
// single-token decode).  Returns the page id, -1 for a no-op (bad/inactive
// slot or per-slot cap), -2 when the pool is exhausted.  A later commit
// that crosses into the reserved page finds pages.size() already
// sufficient and allocates nothing, so the two paths compose.
int32_t eng_reserve_page(Engine* e, int32_t slot_id) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (slot_id < 0 || slot_id >= e->max_slots) return -1;
  Slot& slot = e->slots[slot_id];
  if (!slot.active) return -1;
  if (static_cast<int32_t>(slot.pages.size()) >= e->max_pages_per_slot)
    return -1;
  int32_t p = take_page(e);
  if (p < 0) return -2;
  slot.pages.push_back(p);
  return p;
}

// Release a slot. `hashes` (may be null) are chain hashes for the slot's
// first `n_hashes` full PROMPT pages: any not yet cached are inserted into
// the prefix cache (the cache takes a ref) instead of going straight back to
// the free list; everything else just drops the slot's ref.
void eng_release_cached(Engine* e, int32_t slot_id, const uint64_t* hashes,
                        int32_t n_hashes) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (slot_id < 0 || slot_id >= e->max_slots) return;
  Slot& slot = e->slots[slot_id];
  if (!slot.active) return;
  if (hashes) {
    int32_t n = n_hashes;
    if (n > static_cast<int32_t>(slot.pages.size()))
      n = static_cast<int32_t>(slot.pages.size());
    for (int32_t i = 0; i < n; ++i) {
      uint64_t h = hashes[i];
      if (h == 0) break;  // 0 is the root-parent sentinel, never a real hash
      if (e->cache.count(h)) continue;  // same prefix already cached elsewhere
      uint64_t parent = (i == 0) ? 0 : hashes[i - 1];
      auto pit = e->cache.find(parent);
      if (i > 0 && pit == e->cache.end()) break;  // keep chains contiguous
      if (pit != e->cache.end()) {
        pit->second.children++;
        update_evictable(e, parent, pit->second);
      }
      int32_t pg = slot.pages[i];
      e->refcount[pg]++;  // the cache's ref, on top of the slot's
      e->cache[h] = CacheEntry{pg, parent, 0, ++e->clock, 0, 0};
      e->page_hash[pg] = h;
      // the slot still holds its ref (refcount >= 2), so the new entry
      // starts blocked; the deref loop below unblocks it once only the
      // cache owns the page
      add_blocker(e, h);
    }
  }
  for (int32_t p : slot.pages) deref_page(e, p);
  slot.pages.clear();
  slot.active = false;
  slot.req_id = -1;
  slot.seq_len = 0;
  e->total_completed++;
}

void eng_release(Engine* e, int32_t slot_id) {
  eng_release_cached(e, slot_id, nullptr, 0);
}

// Snapshots for the JAX side (caller provides buffers).
void eng_page_table(Engine* e, int32_t* out /* max_slots*max_pages_per_slot */) {
  std::lock_guard<std::mutex> lock(e->mu);
  for (int32_t s = 0; s < e->max_slots; ++s) {
    const Slot& slot = e->slots[s];
    for (int32_t i = 0; i < e->max_pages_per_slot; ++i) {
      out[s * e->max_pages_per_slot + i] =
          (slot.active && i < static_cast<int32_t>(slot.pages.size()))
              ? slot.pages[i]
              : 0;  // trash page: safe to write AND gather; masked by seq_lens
    }
  }
}

// One slot's page-table row (max_pages_per_slot ints, trash-page padded) —
// fetched once at admission; commits then grow the caller's mirror via
// eng_commit_token_ex's out_new_page.
void eng_slot_pages(Engine* e, int32_t slot_id, int32_t* out) {
  std::lock_guard<std::mutex> lock(e->mu);
  for (int32_t i = 0; i < e->max_pages_per_slot; ++i) out[i] = 0;
  if (slot_id < 0 || slot_id >= e->max_slots) return;
  const Slot& slot = e->slots[slot_id];
  if (!slot.active) return;
  for (size_t i = 0; i < slot.pages.size(); ++i)
    out[i] = slot.pages[i];
}

// Reclaimable-page counts: the O(1) incremental counter the allocator uses,
// and the O(cache) recompute — exposed so tests (and the sanitizer stress
// driver) can assert they never drift.
int32_t eng_reclaimable(Engine* e) {
  std::lock_guard<std::mutex> lock(e->mu);
  return count_reclaimable(e);
}

int32_t eng_reclaimable_slow(Engine* e) {
  std::lock_guard<std::mutex> lock(e->mu);
  return count_reclaimable_slow(e);
}

void eng_seq_lens(Engine* e, int32_t* out /* max_slots */) {
  std::lock_guard<std::mutex> lock(e->mu);
  for (int32_t s = 0; s < e->max_slots; ++s)
    out[s] = e->slots[s].active ? e->slots[s].seq_len : 0;
}

void eng_active_mask(Engine* e, int32_t* out /* max_slots */) {
  std::lock_guard<std::mutex> lock(e->mu);
  for (int32_t s = 0; s < e->max_slots; ++s)
    out[s] = e->slots[s].active ? 1 : 0;
}

int64_t eng_slot_req(Engine* e, int32_t slot_id) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (slot_id < 0 || slot_id >= e->max_slots) return -1;
  return e->slots[slot_id].active ? e->slots[slot_id].req_id : -1;
}

int32_t eng_slot_seq_len(Engine* e, int32_t slot_id) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (slot_id < 0 || slot_id >= e->max_slots) return 0;
  return e->slots[slot_id].seq_len;
}

int32_t eng_num_free_pages(Engine* e) {
  std::lock_guard<std::mutex> lock(e->mu);
  return static_cast<int32_t>(e->free_pages.size());
}

int32_t eng_queue_depth(Engine* e) {
  std::lock_guard<std::mutex> lock(e->mu);
  return static_cast<int32_t>(e->queue.size());
}

int32_t eng_num_active(Engine* e) {
  std::lock_guard<std::mutex> lock(e->mu);
  int32_t n = 0;
  for (const Slot& s : e->slots) n += s.active ? 1 : 0;
  return n;
}

// out[0]=cached pages (== entries), out[1]=page hits, out[2]=page misses,
// out[3]=evictions.
void eng_cache_stats(Engine* e, int64_t* out /* 4 */) {
  std::lock_guard<std::mutex> lock(e->mu);
  out[0] = static_cast<int64_t>(e->cache.size());
  out[1] = e->cache_hits;
  out[2] = e->cache_misses;
  out[3] = e->cache_evictions;
}

}  // extern "C"
