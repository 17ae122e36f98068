// Paged-KV page allocator: host-side bookkeeping of continuous batching.
//
// The port's own copy of flash_attn_tpu/runtime/native/page_allocator.cc
// (same semantics, fatt_ prefix).  Built with the host C++ compiler into
// flash_attn_tpu_torch/_build/<hash>/ and bound with ctypes
// (runtime/abi.py); it needs no CUDA.
//
// Semantics: fixed pool of `num_pages` pages; page 0 is reserved (null
// page).  Sequences acquire pages in bulk at admission and release them at
// completion.  A LIFO free list keeps allocation O(1); fragmentation is
// impossible because pages are uniform.

#include <cstdint>
#include <mutex>
#include <new>
#include <vector>

extern "C" {

struct fatt_page_pool {
  std::vector<int32_t> free_list;  // LIFO of free page ids
  std::vector<int32_t> owner;      // page id -> sequence slot (-1 = free)
  std::mutex mu;
  int32_t num_pages;
};

fatt_page_pool* fatt_pool_create(int32_t num_pages) {
  if (num_pages < 2) return nullptr;
  auto* pool = new (std::nothrow) fatt_page_pool();
  if (!pool) return nullptr;
  pool->num_pages = num_pages;
  pool->owner.assign(num_pages, -1);
  pool->free_list.reserve(num_pages - 1);
  // pushed in reverse so the first allocations are low page ids
  for (int32_t p = num_pages - 1; p >= 1; --p) pool->free_list.push_back(p);
  return pool;
}

void fatt_pool_destroy(fatt_page_pool* pool) { delete pool; }

int32_t fatt_pool_free_count(fatt_page_pool* pool) {
  std::lock_guard<std::mutex> lock(pool->mu);
  return static_cast<int32_t>(pool->free_list.size());
}

// Acquire `n` pages for sequence `slot`; writes page ids into out[0..n).
// Returns n on success, -1 if the pool cannot satisfy the request (the
// caller defers admission; nothing is allocated).
int32_t fatt_pool_acquire(fatt_page_pool* pool, int32_t slot, int32_t n,
                          int32_t* out) {
  std::lock_guard<std::mutex> lock(pool->mu);
  if (static_cast<int32_t>(pool->free_list.size()) < n) return -1;
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = pool->free_list.back();
    pool->free_list.pop_back();
    pool->owner[p] = slot;
    out[i] = p;
  }
  return n;
}

// Release every page owned by `slot`.  Returns the number released.
int32_t fatt_pool_release_slot(fatt_page_pool* pool, int32_t slot) {
  std::lock_guard<std::mutex> lock(pool->mu);
  int32_t released = 0;
  for (int32_t p = 1; p < pool->num_pages; ++p) {
    if (pool->owner[p] == slot) {
      pool->owner[p] = -1;
      pool->free_list.push_back(p);
      ++released;
    }
  }
  return released;
}

int32_t fatt_pool_owner(fatt_page_pool* pool, int32_t page) {
  std::lock_guard<std::mutex> lock(pool->mu);
  if (page < 0 || page >= pool->num_pages) return -2;
  return pool->owner[page];
}

// Transfer ownership of specific pages to `new_slot` (prefix caching: a
// request's full prompt pages go to the cache's pseudo-slot, so releasing
// the request leaves them resident).  Returns the number transferred;
// free or out-of-range pages are skipped.
int32_t fatt_pool_transfer(fatt_page_pool* pool, const int32_t* pages,
                           int32_t n, int32_t new_slot) {
  std::lock_guard<std::mutex> lock(pool->mu);
  int32_t moved = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = pages[i];
    if (p < 1 || p >= pool->num_pages || pool->owner[p] < 0) continue;
    pool->owner[p] = new_slot;
    ++moved;
  }
  return moved;
}

// Release specific pages whatever their owner (prefix-cache eviction).
// Returns the number released; free or out-of-range pages are skipped.
int32_t fatt_pool_release_pages(fatt_page_pool* pool, const int32_t* pages,
                                int32_t n) {
  std::lock_guard<std::mutex> lock(pool->mu);
  int32_t released = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = pages[i];
    if (p < 1 || p >= pool->num_pages || pool->owner[p] < 0) continue;
    pool->owner[p] = -1;
    pool->free_list.push_back(p);
    ++released;
  }
  return released;
}

}  // extern "C"
