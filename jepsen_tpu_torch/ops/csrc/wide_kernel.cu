// Fused wide-stage frontier update for Hopper (sm_90a): the dedup keep
// mask and the fused dedup + domination prune + compaction, over a
// [lanes, n] batch of candidate tables.
//
// Replaces the two Pallas TPU kernels of jepsen_tpu/ops/wide_kernel.py:
//   * _keep_kernel  (keep_mask)              -> wk_keep_mask
//   * _fused_kernel (fused_frontier_update)  -> wk_keep_mask + wk_fused_tail
//
// What bounds it on this card.  The wide rung's candidate table is
// 51,200 or 83,968 rows per lane (capacity 2048, P = 8, G = 16 or 32):
// ~7 MB per lane with the int16 counts, far more than one SM's 227 KB of
// shared memory.  The keep mask's bound is reading that table once (49 MB
// for 8 lanes at G = 32: 0.015 ms); its hash pass also folds two fmix32
// lanes over every column (9 integer operations a column and lane), and
// its sort and kill move a few bytes a row through L2 in a chain of small
// kernels, so what bounds it in practice is integer work and the latency
// of those kernels.  The tail works on the 2C = 4096-row buffer (0.3 MB
// per lane at G = 32): the bytes it must move take about a microsecond,
// so launches and the domination tests within each (state, fok) class
// bound it.
//
// Design (what the Pallas kernel computes, not how it tiled VMEM):
//   The Pallas kernel is one sequential grid sweep with every table in
//   VMEM and an O(n^2) all-pairs bucket-rank sweep.  Hopper's blocks run
//   unordered, so each phase is its own grid over (tiles, lanes).  The
//   first port partitioned rows into atomic super-bucket lists in arbitrary
//   order and had each row scan its list twice (for its bucket rank and
//   for an equal predecessor): a bucket of k copies of one row cost k^2
//   gathers, and the list scan ran one block per lane.  The keep mask is
//   now a stable sort and a stencil, linear in the table whatever the
//   bucket sizes (wk_keep_mask):
//   1. k_hash_keys: one block per 256 rows of a lane, one row a thread.
//      The block's fcr rows are one contiguous range: they are copied to
//      shared memory with 16-byte cp.async (each row's chunks rotated so
//      that a quarter-warp's 16-byte loads hit 8 different bank groups),
//      and each thread folds its row's two murmur fmix32 lanes (the JAX
//      package's hash_rows order) from there.  It writes the hash pair,
//      the packed key [bucket | index] of an alive row (bucket = top
//      bbits of h1, bbits + index bits = 31: the JAX package's
//      _keep_bucket key), keep = 0 for a dead row, and its rows'
//      histogram of the first sort digit (shared atomics).
//   2. k_scan_hist and k_radix_scatter: the first sort pass, a stable
//      scatter of each lane's alive keys (each carrying its hash pair)
//      by the bucket's top digit (8 bits) into bins of whole buckets, in
//      candidate order inside a bin: a digit-major scan of the hash
//      pass's histograms spread over 2048-entry blocks (a reader adds
//      the earlier blocks' totals itself), then 1024-row tiles ranked
//      stably (__match_any_sync peers per warp and scanned (item, warp)
//      counts), laid out sorted in shared memory and written to their
//      digit runs by consecutive threads.
//   3. k_bin_sort_kill, one block per bin: the bin sorted by the
//      bucket's remaining bits (6 or 7 at the main path's 14 and 15
//      bucket bits) the same stable way, then the kill as a stencil over
//      the sorted bin: position q dies iff one of q-1 ... q-window has
//      both hash lanes equal (equal h1 means one bucket, and buckets are
//      contiguous runs in candidate order, so no run start is needed); a
//      kept row overflows iff q - window is in its bucket.  Stable passes
//      keep candidate order inside a bucket, so a row's sorted position
//      minus its bucket's start is its bucket prefix rank.  keep is
//      written in candidate order.  For the fused update, k_chunk_count
//      then counts each 512-row chunk's kept rows (__syncthreads_count)
//      for the tail.
//   Fused tail (wk_fused_tail):
//   4. k_compact1, one block per 512-row chunk of the keep mask: the
//      block adds up the kept counts of the lane's earlier chunks
//      itself (no scan launch), scans its chunk, and copies its
//      survivors' columns into consecutive buffer rows as whole 16-, 8-
//      or 4-byte words, so that neighbouring threads store neighbouring
//      words.  Each buffer row gets its child bit (an explicit column on
//      the mesh path, else positional) and its class hash (state and fok
//      only), counted into one of S = Cb / 8 class super-buckets.
//   5. k_exclusive_scan and k_class_scatter: the lane's class
//      super-bucket lists, end to end (histogram, scan, atomic scatter).
//   6. k_prune_tiles<GW> (G in {4, 8, 16, 32, 64}; k_prune_list, one
//      thread per row with scalar compares, takes other shapes): row j
//      dies iff a row of its class dominates it (the saturating one-hot
//      contract of exact_prune_mxu, as integer compares), and only the
//      rows of j's list are tested.  A block takes 64 list positions as
//      its j rows and stages a slice of their lists' span through shared
//      memory (cp.async, double-buffered); the count compares are 16-bit
//      SIMD (max/min.s16x2), two groups per instruction.  A big class
//      (hundreds of rows, as real frontiers have) is compared block
//      against tile, every thread reading the same staged row; a
//      singleton costs a few compares.
//   7. k_compact2, one block per 512 buffer rows: it counts the lane's
//      survivors before its chunk itself, copies its survivors as whole
//      words, adds their fingerprint (per-warp sums, unsigned atomics,
//      mod 2^32 in any order), zeroes its span of output rows past the
//      survivors, and writes the overflow flag.
//   Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W), on the card
//   alone: the keep mask takes 0.087 ms on the bench G = 32 table (hash
//   pass 0.030, first sort pass 0.014, bins 0.038; the list scans took
//   0.163) and 0.09 ms on tables whose buckets hold hundreds or
//   thousands of copies of one row (the list scans: 0.67 and 4.2 ms).  The tail
//   takes 0.045 ms (bound 0.0013 ms by bytes; prune 0.015, compactions
//   0.010 and 0.011, lists 0.005) and 0.073 ms on the class-heavy table
//   (prune 0.042-0.049); the whole update 0.13 ms.  A call from Python can
//   cost more host time than card time (allocation, ctypes, about a
//   dozen launches).
//
// C interface for ctypes: every entry point launches on the caller's
// stream, allocates nothing (the caller passes every buffer), does not
// synchronise, and returns cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kHashSeed1 = 0x0B00B135u;
constexpr uint32_t kHashSeed2 = 0x1CEB00DAu;
constexpr uint32_t kFpSeed1 = 0xFEED0001u;
constexpr uint32_t kFpSeed2 = 0xFEED0002u;
constexpr uint32_t kGolden = 0x9E3779B9u;

// Rows per block of the first compaction (one row per thread), and the
// chunk of the keep mask's per-chunk kept counts; the Python wrapper
// sizes the count table with it.
constexpr int kChunkRows = 512;
constexpr int kRowThreads = 256;
constexpr int kScanThreads = 1024;
// The keep mask: rows per sort tile, threads per block (and rows per
// hash block), items per thread; the widest sort digit; histogram
// entries per scan block.
constexpr int kTileRows = 1024;
constexpr int kSortThreads = 256;
constexpr int kItems = kTileRows / kSortThreads;
constexpr int kMaxDigitBits = 8;
constexpr int kMaxBins = 1 << kMaxDigitBits;
constexpr int kScanItems = 8;
constexpr int kScanChunk = kSortThreads * kScanItems;
// Bucket bits the bin kernel sorts itself (the first pass takes the rest,
// at most kMaxDigitBits): bins of a few hundred rows at the main path's
// tables.
constexpr int kBinBits = 8;
// Window neighbours the stencil loads together.
constexpr int kUnrolledWindow = 8;

// The tiled prune: j rows per block (one per thread) and i rows per
// staged tile; blocks that share one j tile, each with a slice of its
// list span; fok words it stages (P <= 128).
constexpr int kPruneRows = 64;
constexpr int kPruneSplit = 4;
constexpr int kPruneMaxW = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  // the shifts as high products run on the multiply pipe, beside the
  // xors on the integer pipe
  x ^= __umulhi(x, 1u << 16);
  x *= 0x85EBCA6Bu;
  x ^= __umulhi(x, 1u << 19);
  x *= 0xC2B2AE35u;
  x ^= __umulhi(x, 1u << 16);
  return x;
}

// The two hash lanes of row r with seeds s1/s2: state, fok lanes, fcr
// groups, in that order (hashing.hash_rows).
__device__ __forceinline__ void row_hash(
    const int32_t* __restrict__ state, const uint32_t* __restrict__ fok,
    const int16_t* __restrict__ fcr, int64_t r, int W, int G, uint32_t s1,
    uint32_t s2, uint32_t& h1, uint32_t& h2) {
  uint32_t a = s1 ^ kGolden, b = s2 ^ kGolden;
  uint32_t c = static_cast<uint32_t>(state[r]);
  a = mix32(a ^ c);
  b = mix32(b ^ c);
  for (int w = 0; w < W; ++w) {
    c = fok[r * W + w];
    a = mix32(a ^ c);
    b = mix32(b ^ c);
  }
  for (int g = 0; g < G; ++g) {
    c = static_cast<uint32_t>(static_cast<int32_t>(fcr[r * G + g]));
    a = mix32(a ^ c);
    b = mix32(b ^ c);
  }
  h1 = a;
  h2 = b;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Exclusive scan of one int per thread over the block; *total gets the
// block sum.  blockDim.x must be a multiple of 32; every thread of the
// block must call it.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    int s = (lane < nw) ? warp_sums[lane] : 0;
    s = warp_inclusive_scan(s);
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int base = (wid > 0) ? warp_sums[wid - 1] : 0;
  *total = warp_sums[nw - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return base + inc - v;
}

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(N)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Dedup (keep mask): row hash, stable radix sort of the alive rows by
// bucket, windowed kill over the sorted order
// ---------------------------------------------------------------------------

// The packed sort key of an alive row: [0 | bucket:bbits | index:ibits]
// (bbits + ibits = 31, hashing._bucket_bits).  Sorting the keys sorts
// by bucket with candidate order inside each bucket, so a row's sorted
// position minus its bucket's first position is its bucket prefix rank.
// A dead row's key is kDeadKey (top bit set): it never enters the sort.
constexpr uint32_t kDeadKey = 0xFFFFFFFFu;

// A sort digit: bits [shift, shift + width) of the key.
struct Digit {
  int shift;
  int bins;  // 1 << width
};

__device__ __forceinline__ int digit_of(uint32_t key, Digit d) {
  return static_cast<int>(key >> d.shift) & (d.bins - 1);
}

// The fcr chunk (16 bytes) s of staged row i sits at chunk position
// (s + rot) % K of the row (K chunks a row), with rot chosen so that the
// 8 rows a quarter-warp reads with 16-byte loads fall in 8 different
// 16-byte bank groups: rows of one 128-byte line differ in line offset,
// rows of consecutive lines in rotation.
template <int K>
__device__ __forceinline__ int stage_rot(int i) {
  constexpr int kPerLine = K >= 8 ? 1 : 8 / K;
  return (i / kPerLine) % K;
}

__device__ __forceinline__ void fold_word(uint32_t& a, uint32_t& b, uint32_t c) {
  a = mix32(a ^ c);
  b = mix32(b ^ c);
}

// Fold two int16 counts packed in one little-endian word, low one first.
__device__ __forceinline__ void fold_pair(uint32_t& a, uint32_t& b, uint32_t w) {
  fold_word(a, b, static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(w & 0xFFFFu))));
  fold_word(a, b, static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(w >> 16))));
}

// The sum of a lane's chunk totals cs[0..nch) from k_scan_hist (the
// lane's alive rows), with the whole block; every thread must call it.
__device__ int lane_total(const int32_t* __restrict__ cs, int nch) {
  int v = 0;
  for (int c = threadIdx.x; c < nch; c += blockDim.x) v += cs[c];
  int tot;
  block_exclusive_scan(v, &tot);
  return tot;
}

// Entry e's lane-wide offset: its scanned value plus the totals of the
// lane's earlier chunks (loaded together, eight at a time).
__device__ __forceinline__ int hist_offset(const int32_t* __restrict__ h,
                                           const int32_t* __restrict__ cs, int e) {
  int off = h[e];
  const int nc = e / kScanChunk;
  for (int c0 = 0; c0 < nc; c0 += 8) {
#pragma unroll
    for (int c = c0; c < c0 + 8; ++c) off += (c < nc) ? cs[c] : 0;
  }
  return off;
}

// The row hashes, the packed keys and the first sort pass's histogram.
// Block (b, l) takes rows [b * kSortThreads, +kSortThreads) of lane l,
// one row a thread: a sub-tile of kTileRows / kSortThreads per sort
// tile.  K > 0 (G = 8K for K in {1, 2, 4, 8}, fcr 16-byte aligned): the
// block's fcr rows, one contiguous range of K 16-byte chunks a row, are
// copied to shared memory with 16-byte cp.async (rotated per row, see
// stage_rot), and each thread reads its row from there with 16-byte
// loads; K = 0 (other shapes): each thread reads its row's counts from
// device memory.  Writes hh[r] = (h1, h2), key[r], keep[r] = 0 for a
// dead row, the sub-tile's count of alive rows per digit d0 (shared
// atomics, then one column of hist [L][bins][cols]), and block 0 zeroes
// ovf.
template <int K>
__global__ void __launch_bounds__(kSortThreads)
    k_hash_keys(int n, int W, int G, int bbits, int ibits, Digit d0, int cols,
                const int32_t* __restrict__ state,
                const uint32_t* __restrict__ fok,
                const int16_t* __restrict__ fcr,
                const uint8_t* __restrict__ alive, uint2* __restrict__ hh,
                uint32_t* __restrict__ key, uint8_t* __restrict__ keep,
                int32_t* __restrict__ hist, uint8_t* __restrict__ ovf) {
  extern __shared__ __align__(16) uint8_t s_fcr[];
  __shared__ int s_hist[kMaxBins];
  const int l = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int v = tid; v < d0.bins; v += kSortThreads) s_hist[v] = 0;
  if (b == 0 && tid == 0) ovf[l] = 0;
  const int64_t lane0 = static_cast<int64_t>(l) * n;
  const int r0 = b * kSortThreads;
  const int rows = min(kSortThreads, n - r0);
  const int i = r0 + tid;
  const int64_t r = lane0 + i;
  // the row's other columns, loaded while the counts are staged
  uint32_t st = 0u, fo0 = 0u;
  bool live = false;
  if (tid < rows) {
    st = static_cast<uint32_t>(state[r]);
    fo0 = W > 0 ? fok[r * W] : 0u;
    live = alive[r] != 0;
  }
  if constexpr (K > 0) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(fcr + (lane0 + r0) * G);
    for (int c = tid; c < rows * K; c += kSortThreads) {
      const int row = c / K;
      const int s = c % K;
      cp_async<16>(s_fcr + 16 * (row * K + (s + stage_rot<K>(row)) % K), src + 16 * c);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if (tid < rows) {
    uint32_t a = kHashSeed1 ^ kGolden, h = kHashSeed2 ^ kGolden;
    fold_word(a, h, st);
    if (W > 0) fold_word(a, h, fo0);
    for (int w = 1; w < W; ++w) fold_word(a, h, fok[r * W + w]);
    if constexpr (K > 0) {
      const int rot = stage_rot<K>(tid);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const uint4 v = *reinterpret_cast<const uint4*>(s_fcr + 16 * (tid * K + (s + rot) % K));
        fold_pair(a, h, v.x);
        fold_pair(a, h, v.y);
        fold_pair(a, h, v.z);
        fold_pair(a, h, v.w);
      }
    } else {
      for (int g = 0; g < G; ++g) {
        fold_word(a, h, static_cast<uint32_t>(static_cast<int32_t>(fcr[r * G + g])));
      }
    }
    hh[r] = make_uint2(a, h);
    if (live) {
      const uint32_t k = ((a >> (32 - bbits)) << ibits) | static_cast<uint32_t>(i);
      key[r] = k;
      atomicAdd(&s_hist[digit_of(k, d0)], 1);
    } else {
      key[r] = kDeadKey;
      keep[r] = 0;
    }
  }
  __syncthreads();
  for (int v = tid; v < d0.bins; v += kSortThreads) {
    hist[(static_cast<int64_t>(l) * d0.bins + v) * cols + b] = s_hist[v];
  }
}

// In-place exclusive scan of each lane's histogram [bins][cols],
// flattened digit-major (E = bins * cols entries), in chunks of
// kScanChunk entries: block (c, l) scans chunk c of lane l and writes its
// total to csum [L][nch].  An entry's lane-wide offset is its scanned
// value plus the totals of the lane's earlier chunks (hist_offset).
__global__ void __launch_bounds__(kSortThreads)
    k_scan_hist(int E, int nch, int32_t* __restrict__ hist,
                int32_t* __restrict__ csum) {
  const int l = blockIdx.y;
  const int c = blockIdx.x;
  int32_t* h = hist + static_cast<int64_t>(l) * E;
  const int e0 = c * kScanChunk + threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = (e0 + k < E) ? h[e0 + k] : 0;
    sum += v[k];
  }
  int tot;
  int run = block_exclusive_scan(sum, &tot);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (e0 + k < E) h[e0 + k] = run;
    run += v[k];
  }
  if (threadIdx.x == 0) csum[static_cast<int64_t>(l) * nch + c] = tot;
}

// The first sort pass: a stable scatter of each lane's alive keys, each
// carrying its hash pair, by their top digit d, so that each lane's keys
// end up grouped into bins of whole buckets, in candidate order inside a
// bin.  Block (t, l) takes rows [t * kTileRows, +kTileRows) of lane l,
// kItems a thread (row t * kTileRows + k * kSortThreads + tid, so that
// (k, warp, lane) is row order); dead keys are skipped.  The histogram
// has a column per hash block, kItems of them a tile: the tile's run of
// digit v starts at the scanned entry of (v, t * kItems).
// Ranks inside the tile are stable: each warp groups its keys by digit
// (__match_any_sync) and ranks them by lane; the (item, warp) counts of
// each digit are scanned in row order.  The tile's keys and hash pairs
// are then laid out in shared memory in sorted order and written to
// their runs by consecutive threads.
__global__ void __launch_bounds__(kSortThreads)
    k_radix_scatter(int n, Digit d, int cols, int nch,
                    const int32_t* __restrict__ hist,
                    const int32_t* __restrict__ csum,
                    const uint32_t* __restrict__ kin,
                    const uint2* __restrict__ hin,
                    uint32_t* __restrict__ kout, uint2* __restrict__ hout) {
  constexpr int kGroups = kItems * (kSortThreads / 32);
  // the (item, warp) counts, then (aliased) the tile in sorted order
  __shared__ __align__(16) int s_cnt[kGroups * kMaxBins];
  __shared__ int s_base[kMaxBins];  // lane-wide run start of each digit
  __shared__ int s_off[kMaxBins];   // tile-local start of each digit
  static_assert(kTileRows * (sizeof(uint32_t) + sizeof(uint2)) <= sizeof(s_cnt),
                "the sorted tile must fit in the count table");
  uint32_t* s_key = reinterpret_cast<uint32_t*>(s_cnt);
  uint2* s_h = reinterpret_cast<uint2*>(s_cnt + kTileRows);
  const int l = blockIdx.y;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int64_t lane0 = static_cast<int64_t>(l) * n;
  // the tile's keys and hash pairs, loaded before the offsets are known
  uint32_t key[kItems];
  uint2 hv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int q = t * kTileRows + k * kSortThreads + tid;
    key[k] = q < n ? kin[lane0 + q] : kDeadKey;
    if (key[k] != kDeadKey) hv[k] = hin[lane0 + q];
  }
  const int32_t* cs = csum + static_cast<int64_t>(l) * nch;
  const int32_t* h = hist + static_cast<int64_t>(l) * d.bins * cols;
  for (int v = tid; v < d.bins; v += kSortThreads) {
    s_base[v] = hist_offset(h, cs, v * cols + t * kItems);
  }
  for (int u = tid; u < kGroups * kMaxBins; u += kSortThreads) s_cnt[u] = 0;
  __syncthreads();
  int dig[kItems], rank[kItems];
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    dig[k] = (key[k] == kDeadKey) ? d.bins : digit_of(key[k], d);
    const unsigned peers = __match_any_sync(0xffffffffu, dig[k]);
    rank[k] = __popc(peers & lt);
    if (dig[k] < d.bins && lane == __ffs(peers) - 1) {
      s_cnt[(k * (kSortThreads / 32) + wid) * kMaxBins + dig[k]] = __popc(peers);
    }
  }
  __syncthreads();
  // each digit's (item, warp) counts to exclusive offsets, in position
  // order; the digit's tile total to the scan below
  int tot_v = 0;
  if (tid < d.bins) {
    for (int g = 0; g < kGroups; ++g) {
      const int c = s_cnt[g * kMaxBins + tid];
      s_cnt[g * kMaxBins + tid] = tot_v;
      tot_v += c;
    }
  }
  int nvalid;
  const int off_v = block_exclusive_scan(tot_v, &nvalid);
  if (tid < d.bins) s_off[tid] = off_v;
  __syncthreads();
  int li[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    li[k] = (dig[k] < d.bins)
                ? s_off[dig[k]] + s_cnt[(k * (kSortThreads / 32) + wid) * kMaxBins + dig[k]] + rank[k]
                : -1;
  }
  __syncthreads();  // s_key and s_h overwrite the counts
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (li[k] >= 0) {
      s_key[li[k]] = key[k];
      s_h[li[k]] = hv[k];
    }
  }
  __syncthreads();
  for (int j = tid; j < nvalid; j += kSortThreads) {
    const uint32_t k = s_key[j];
    const int v = digit_of(k, d);
    const int64_t o = lane0 + s_base[v] + (j - s_off[v]);
    kout[o] = k;
    hout[o] = s_h[j];
  }
}

// Entry e's lane-wide offset (see hist_offset), with the whole block:
// the earlier chunks' totals are loaded in parallel and summed.  Every
// thread must call it.
__device__ int block_hist_offset(const int32_t* __restrict__ h,
                                 const int32_t* __restrict__ cs, int e) {
  int v = 0;
  for (int c = threadIdx.x; c < e / kScanChunk; c += blockDim.x) v += cs[c];
  int tot;
  block_exclusive_scan(v, &tot);
  return h[e] + tot;
}

// After the first pass each lane's alive keys are grouped by their top
// digit into bins of whole buckets, in candidate order inside a bin.
// Block (v, l) finishes bin v of lane l:
//   * an LSD sort of the bin by the remaining rbits bucket bits, in
//     digits of rwidth bits: per digit the bin's counts (shared atomics)
//     and their scan, then stable ranks in rounds of kTileRows keys
//     (warp peers and scanned (item, warp) counts, as in the first pass,
//     with running counts across rounds), scattering between the two
//     buffers over the bin's range;
//   * the kill, a stencil over the sorted bin: position q is a duplicate
//     iff one of q-1 ... q-window has both hash lanes equal.  Equal h1
//     means the same bucket and buckets are contiguous runs in candidate
//     order, so those are the bucket's alive rows j < i with pre[i] -
//     pre[j] <= window, and no position before the bin can match.  A
//     kept row overflows iff q - window is in the bin and in its bucket
//     (pre >= window).  keep is written in candidate order.
// A bin holds every copy of a row, so the work is linear in the bin.
__global__ void __launch_bounds__(kSortThreads)
    k_bin_sort_kill(int n, int ibits, int rbits, int rwidth, int window,
                    int cols, int nch, const int32_t* __restrict__ hist,
                    const int32_t* __restrict__ csum,
                    uint32_t* __restrict__ ka, uint2* __restrict__ ha,
                    uint32_t* __restrict__ kb, uint2* __restrict__ hb,
                    uint8_t* __restrict__ keep, uint8_t* __restrict__ ovf) {
  constexpr int kGroups = kItems * (kSortThreads / 32);
  extern __shared__ int s_cnt[];    // [kGroups][1 << rwidth]
  __shared__ int s_off[kMaxBins];   // bin-local start of each digit
  __shared__ int s_run[kMaxBins];   // keys of each digit placed so far
  const int l = blockIdx.y;
  const int v = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int64_t lane0 = static_cast<int64_t>(l) * n;
  const int32_t* cs = csum + static_cast<int64_t>(l) * nch;
  const int32_t* h = hist + static_cast<int64_t>(l) * gridDim.x * cols;
  const int s = block_hist_offset(h, cs, v * cols);
  const int e = v + 1 < static_cast<int>(gridDim.x)
                    ? block_hist_offset(h, cs, (v + 1) * cols)
                    : lane_total(cs, nch);
  if (s >= e) return;
  const unsigned lt = (1u << lane) - 1u;
  for (int shift = 0; shift < rbits; shift += rwidth) {
    const Digit d{ibits + shift, 1 << min(rwidth, rbits - shift)};
    for (int u = tid; u < d.bins; u += kSortThreads) {
      s_off[u] = 0;
      s_run[u] = 0;
    }
    __syncthreads();
    for (int q = s + tid; q < e; q += kSortThreads) {
      atomicAdd(&s_off[digit_of(ka[lane0 + q], d)], 1);
    }
    __syncthreads();
    int tot;
    const int ex = block_exclusive_scan(tid < d.bins ? s_off[tid] : 0, &tot);
    if (tid < d.bins) s_off[tid] = ex;
    for (int r0 = s; r0 < e; r0 += kTileRows) {
      for (int u = tid; u < kGroups * d.bins; u += kSortThreads) s_cnt[u] = 0;
      __syncthreads();
      uint32_t key[kItems];
      uint2 hv[kItems];
      int dig[kItems], rank[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int q = r0 + k * kSortThreads + tid;
        key[k] = q < e ? ka[lane0 + q] : kDeadKey;
        if (q < e) hv[k] = ha[lane0 + q];
      }
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        dig[k] = key[k] == kDeadKey ? d.bins : digit_of(key[k], d);
        const unsigned peers = __match_any_sync(0xffffffffu, dig[k]);
        rank[k] = __popc(peers & lt);
        if (dig[k] < d.bins && lane == __ffs(peers) - 1) {
          s_cnt[(k * (kSortThreads / 32) + wid) * d.bins + dig[k]] = __popc(peers);
        }
      }
      __syncthreads();
      if (tid < d.bins) {
        int run = s_run[tid];
        for (int g = 0; g < kGroups; ++g) {
          const int c = s_cnt[g * d.bins + tid];
          s_cnt[g * d.bins + tid] = run;
          run += c;
        }
        s_run[tid] = run;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (dig[k] < d.bins) {
          const int64_t o = lane0 + s + s_off[dig[k]] +
                            s_cnt[(k * (kSortThreads / 32) + wid) * d.bins + dig[k]] + rank[k];
          kb[o] = key[k];
          hb[o] = hv[k];
        }
      }
      __syncthreads();  // the next round's counts, and the next pass's reads
    }
    uint32_t* kt = ka;
    ka = kb;
    kb = kt;
    uint2* ht = ha;
    ha = hb;
    hb = ht;
  }
  const uint32_t imask = (1u << ibits) - 1u;
  bool any_ovf = false;
  for (int q = s + tid; q < e; q += kSortThreads) {
    const uint32_t k = ka[lane0 + q];
    const uint2 hq = ha[lane0 + q];
    const uint32_t kw = q - window >= s ? ka[lane0 + q - window] : kDeadKey;
    bool dup = false;
    // the first kUnrolledWindow neighbours are loaded together
#pragma unroll
    for (int j = 1; j <= kUnrolledWindow; ++j) {
      if (j <= window && q - j >= s) {
        const uint2 g = ha[lane0 + q - j];
        dup = dup || (g.x == hq.x && g.y == hq.y);
      }
    }
    for (int p = q - kUnrolledWindow - 1; p >= max(s, q - window) && !dup; --p) {
      const uint2 g = ha[lane0 + p];
      dup = g.x == hq.x && g.y == hq.y;
    }
    keep[lane0 + (k & imask)] = dup ? 0 : 1;
    any_ovf = any_ovf || (!dup && kw != kDeadKey && (kw >> ibits) == (k >> ibits));
  }
  if (any_ovf) ovf[l] = 1;
}

// The kept rows of each kChunkRows chunk of the keep mask, in candidate
// order, for the fused tail's first compaction.
__global__ void __launch_bounds__(kChunkRows)
    k_chunk_count(int n, const uint8_t* __restrict__ keep,
                  int32_t* __restrict__ chunk_cnt) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * kChunkRows + threadIdx.x;
  const int c = __syncthreads_count(i < n && keep[static_cast<int64_t>(l) * n + i]);
  if (threadIdx.x == 0) chunk_cnt[static_cast<int64_t>(l) * gridDim.x + blockIdx.x] = c;
}

// ---------------------------------------------------------------------------
// Fused tail: compaction to the 2C buffer with the class partition, the
// class-partitioned domination prune, compaction to capacity with the
// fingerprint
// ---------------------------------------------------------------------------

// Per-lane exclusive scan of in[l, 0..S) into out (and out2 when given).
// One block per lane.
__global__ void k_exclusive_scan(int S, const int32_t* __restrict__ in,
                                 int32_t* __restrict__ out,
                                 int32_t* __restrict__ out2) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * S;
  int carry = 0;
  for (int s0 = 0; s0 < S; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const int v = (s < S) ? in[base + s] : 0;
    int tot;
    const int ex = block_exclusive_scan(v, &tot);
    if (s < S) {
      out[base + s] = carry + ex;
      if (out2 != nullptr) out2[base + s] = carry + ex;
    }
    carry += tot;
  }
}

// Copy k rows of rb bytes with the whole block: destination row t (rows
// consecutive from dst) <- source row sidx[t] of src, in the widest word
// that divides rb and both bases, so that neighbouring threads store
// neighbouring words.
template <typename V>
__device__ __forceinline__ void copy_rows_v(const uint8_t* __restrict__ src,
                                            uint8_t* __restrict__ dst, int rb,
                                            const int32_t* sidx, int k) {
  const int per = rb / static_cast<int>(sizeof(V));
  const int total = k * per;
  for (int u = threadIdx.x; u < total; u += blockDim.x) {
    const int t = u / per;
    const int c = u - t * per;
    reinterpret_cast<V*>(dst)[u] =
        reinterpret_cast<const V*>(src + static_cast<int64_t>(sidx[t]) * rb)[c];
  }
}

__device__ void copy_rows(const void* src, void* dst, int rb,
                          const int32_t* sidx, int k) {
  if (rb <= 0 || k <= 0) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst) |
                      static_cast<uintptr_t>(rb);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  if ((a & 15) == 0) {
    copy_rows_v<int4>(s, d, rb, sidx, k);
  } else if ((a & 7) == 0) {
    copy_rows_v<int2>(s, d, rb, sidx, k);
  } else if ((a & 3) == 0) {
    copy_rows_v<int>(s, d, rb, sidx, k);
  } else if ((a & 1) == 0) {
    copy_rows_v<short>(s, d, rb, sidx, k);
  } else {
    copy_rows_v<uint8_t>(s, d, rb, sidx, k);
  }
}

template <typename V>
__device__ __forceinline__ void zero_words(uint8_t* dst, int64_t words) {
  const V z{};
  for (int64_t u = threadIdx.x; u < words; u += blockDim.x) {
    reinterpret_cast<V*>(dst)[u] = z;
  }
}

// Zero k consecutive rows of rb bytes from dst with the whole block, in
// the widest word that divides the span and its base.
__device__ void zero_rows(void* dst, int rb, int k) {
  const int64_t bytes = static_cast<int64_t>(rb) * k;
  if (bytes <= 0) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | static_cast<uintptr_t>(bytes);
  uint8_t* d = static_cast<uint8_t*>(dst);
  if ((a & 15) == 0) {
    zero_words<int4>(d, bytes / 16);
  } else if ((a & 7) == 0) {
    zero_words<int2>(d, bytes / 8);
  } else if ((a & 3) == 0) {
    zero_words<int>(d, bytes / 4);
  } else if ((a & 1) == 0) {
    zero_words<short>(d, bytes / 2);
  } else {
    zero_words<uint8_t>(d, bytes);
  }
}

// Two signed 16-bit lanes per word: Hopper's max/min.s16x2.
__device__ __forceinline__ uint32_t vmax_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t vmin_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The first compaction.  Block (b, l) takes the keep mask's chunk b of
// lane l.  Its offset in the buffer is the sum of k_chunk_count's kept counts
// of the lane's earlier chunks, which the block adds up itself (no scan
// launch); block 0 writes the lane's total nk0.  The chunk's survivors
// go to shared memory in candidate order, and the block copies their
// columns as whole words into consecutive buffer rows.  Each buffer row
// also gets its child bit (the explicit child column on the mesh path,
// whose routing scrambled candidate order, else positional: rows at or
// past n_parents are expansions, none when n_parents < 0), its class
// hash (state and fok only: row_hash's first lane with G = 0), counted
// into the lane's class super-bucket S = 2^cbits, and dead = 0.  Block
// 0 also zeroes the lane's fingerprint words for k_compact2.
__global__ void __launch_bounds__(kChunkRows)
    k_compact1(int n, int nchunks, int Cb, int W, int G, int n_parents, int S,
               int cb_shift, const int32_t* __restrict__ state,
               const uint32_t* __restrict__ fok,
               const int16_t* __restrict__ fcr,
               const uint8_t* __restrict__ child,
               const uint8_t* __restrict__ keep,
               const int32_t* __restrict__ chunk_cnt,
               int32_t* __restrict__ nk0, int32_t* __restrict__ bst,
               uint32_t* __restrict__ bfo, int16_t* __restrict__ bfc,
               uint8_t* __restrict__ bch, uint8_t* __restrict__ dead,
               uint32_t* __restrict__ bcls, int32_t* __restrict__ ccnt,
               uint64_t* __restrict__ fp) {
  __shared__ int32_t sidx[kChunkRows];
  const int l = blockIdx.y;
  const int b = blockIdx.x;
  if (b == 0 && threadIdx.x < 3) fp[static_cast<int64_t>(l) * 3 + threadIdx.x] = 0u;
  int before = 0, all = 0;
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
    const int v = chunk_cnt[static_cast<int64_t>(l) * nchunks + c];
    all += v;
    if (c < b) before += v;
  }
  block_exclusive_scan(before, &before);
  block_exclusive_scan(all, &all);
  if (b == 0 && threadIdx.x == 0) nk0[l] = all;
  const int i = b * kChunkRows + threadIdx.x;
  const int64_t lane_n = static_cast<int64_t>(l) * n;
  const int k = (i < n) ? keep[lane_n + i] : 0;
  int tot;
  const int ex = block_exclusive_scan(k, &tot);
  if (k) sidx[ex] = i;
  __syncthreads();
  const int kc = max(0, min(tot, Cb - before));
  if (kc == 0) return;
  const int64_t o0 = static_cast<int64_t>(l) * Cb + before;
  copy_rows(state + lane_n, bst + o0, 4, sidx, kc);
  copy_rows(fok + lane_n * W, bfo + o0 * W, 4 * W, sidx, kc);
  copy_rows(fcr + lane_n * G, bfc + o0 * G, 2 * G, sidx, kc);
  if (static_cast<int>(threadIdx.x) < kc) {
    const int src = sidx[threadIdx.x];
    const int64_t r = lane_n + src;
    const int64_t o = o0 + threadIdx.x;
    bch[o] = (child != nullptr)
                 ? static_cast<uint8_t>(child[r] != 0)
                 : static_cast<uint8_t>(n_parents >= 0 && src >= n_parents);
    uint32_t h, h2;
    row_hash(state, fok, fcr, r, W, 0, kHashSeed1, kHashSeed2, h, h2);
    bcls[o] = h;
    dead[o] = 0;
    atomicAdd(&ccnt[static_cast<int64_t>(l) * S + (h >> cb_shift)], 1);
  }
}

// Buffer row j into its class super-bucket's list (atomic cursor; the
// order inside a list is arbitrary: the prune is an existence test).
__global__ void k_class_scatter(int Cb, int S, int cb_shift,
                                const int32_t* __restrict__ nk0,
                                const uint32_t* __restrict__ bcls,
                                int32_t* __restrict__ cursor,
                                int32_t* __restrict__ list) {
  const int l = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= min(nk0[l], Cb)) return;
  const int64_t lane0 = static_cast<int64_t>(l) * Cb;
  const int slot = atomicAdd(
      &cursor[static_cast<int64_t>(l) * S + (bcls[lane0 + j] >> cb_shift)], 1);
  list[lane0 + slot] = j;
}

// The domination prune over class lists, for G = 2 * GW groups in
// {4, 8, 16, 32, 64} and at most kPruneMaxW fok words.  The lane's lists
// lie end to end in list order; block (jt, part) takes list positions
// [jt * kPruneRows, +kPruneRows) as its j rows, one per thread.  Those
// rows' lists form one span of list positions; the block takes slice
// `part` of kPruneSplit of it and stages it in tiles of kPruneRows i
// rows through shared memory (cp.async, double-buffered), and each
// thread tests its j against the staged rows of its own list.  A block
// inside one long list (a big class) so compares kPruneRows j rows with
// a quarter of the class from shared memory, with every thread reading
// the same i row (a broadcast); a block over short lists stages little
// more than its own rows.  j dies when an i != j of its class (state and
// fok equal: a super-bucket may hold several classes) has
//   le_ij = pos_j and fcr_i <= sat_j on every group, sat = min(fcr, m-1),
// and either i < j or not le_ji.  pos_j: m >= 1 and no negative count
// (every sat_j >= 0).  The compares are 16-bit SIMD, two groups per
// word: fcr_i <= sat_j on both lanes iff max(fcr_i, sat_j) == sat_j,
// OR-ed over the words; le_ji = pos_i and fcr_j <= m-1 and fcr_j <=
// fcr_i (the same max test).  Signed lanes, so any int16 count is exact.
// A kill is written as dead[j] = 1 by whichever block finds one (dead
// was zeroed by k_compact1), so the slices need no merge.
template <int GW>
__global__ void __launch_bounds__(kPruneRows)
    k_prune_tiles(int Cb, int W, int S, int cb_shift, int m,
                  const int32_t* __restrict__ nk0,
                  const int32_t* __restrict__ bst,
                  const uint32_t* __restrict__ bfo,
                  const int16_t* __restrict__ bfc,
                  const uint32_t* __restrict__ bcls,
                  const int32_t* __restrict__ coff,
                  const int32_t* __restrict__ ccnt,
                  const int32_t* __restrict__ list,
                  uint8_t* __restrict__ dead) {
  __shared__ __align__(16) uint32_t s_f[2][kPruneRows][GW];
  __shared__ uint32_t s_fo[2][kPruneRows][kPruneMaxW];
  __shared__ int32_t s_st[2][kPruneRows];
  __shared__ int32_t s_idx[2][kPruneRows];
  __shared__ int s_span[2];
  const int l = blockIdx.y;
  const int jt = blockIdx.x / kPruneSplit;
  const int part = blockIdx.x - jt * kPruneSplit;
  const int nv = min(nk0[l], Cb);
  const int p0 = jt * kPruneRows;
  if (p0 >= nv) return;
  const int64_t lane0 = static_cast<int64_t>(l) * Cb;
  const int p = p0 + threadIdx.x;
  const bool active = p < nv;
  int j = -1, a = 0, b = 0;
  if (active) {
    j = list[lane0 + p];
    const int64_t sbi = static_cast<int64_t>(l) * S + (bcls[lane0 + j] >> cb_shift);
    a = coff[sbi];
    b = a + ccnt[sbi];
  }
  if (p == p0) s_span[0] = a;
  if (p == min(p0 + kPruneRows, nv) - 1) s_span[1] = b;
  __syncthreads();
  const int per = (s_span[1] - s_span[0] + kPruneSplit - 1) / kPruneSplit;
  const int lo = s_span[0] + part * per;
  const int hi = min(s_span[1], lo + per);
  if (lo >= hi) return;

  // j's row in registers: its counts, saturated counts and class.
  const uint32_t mm = static_cast<uint32_t>(static_cast<uint16_t>(m - 1)) * 0x10001u;
  uint32_t fj[GW], sj[GW], foj[kPruneMaxW];
  int32_t stj = 0;
  bool capj = true;
  uint32_t sign = 0u;
#pragma unroll
  for (int w = 0; w < GW; ++w) {
    fj[w] = 0u;
    sj[w] = 0u;
  }
#pragma unroll
  for (int w = 0; w < kPruneMaxW; ++w) foj[w] = 0u;
  if (active) {
    const int64_t bj = lane0 + j;
    const uint32_t* fw = reinterpret_cast<const uint32_t*>(bfc) + bj * GW;
#pragma unroll
    for (int w = 0; w < GW; ++w) {
      fj[w] = fw[w];
      sj[w] = vmin_s16x2(fj[w], mm);
      capj = capj && vmax_s16x2(fj[w], mm) == mm;
      sign |= fj[w];
    }
    stj = bst[bj];
#pragma unroll
    for (int w = 0; w < kPruneMaxW; ++w) {
      if (w < W) foj[w] = bfo[bj * W + w];
    }
  }
  const bool posj = m >= 1 && (sign & 0x80008000u) == 0u;
  bool killed = false;
  bool done = !active || !posj;

  auto stage = [&](int t, int buf) {
    const int q = lo + t * kPruneRows + threadIdx.x;
    if (q < hi) {
      const int i = list[lane0 + q];
      const int64_t bi = lane0 + i;
      s_idx[buf][threadIdx.x] = i;
      cp_async<4>(&s_st[buf][threadIdx.x], bst + bi);
      for (int w = 0; w < W; ++w) {
        cp_async<4>(&s_fo[buf][threadIdx.x][w], bfo + bi * W + w);
      }
      const uint32_t* fw = reinterpret_cast<const uint32_t*>(bfc) + bi * GW;
      if constexpr (GW % 4 == 0) {
#pragma unroll
        for (int w = 0; w < GW; w += 4) cp_async<16>(&s_f[buf][threadIdx.x][w], fw + w);
      } else {
#pragma unroll
        for (int w = 0; w < GW; w += 2) cp_async<8>(&s_f[buf][threadIdx.x][w], fw + w);
      }
    }
    cp_async_commit();
  };

  const int ntiles = (hi - lo + kPruneRows - 1) / kPruneRows;
  stage(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!done) {
      const int q0 = lo + t * kPruneRows;
      const int i0 = max(a - q0, 0);
      const int i1 = min(min(b, hi) - q0, kPruneRows);
      for (int ii = i0; ii < i1; ++ii) {
        const int i = s_idx[buf][ii];
        if (i == j || s_st[buf][ii] != stj) continue;
        bool same = true;
#pragma unroll
        for (int w = 0; w < kPruneMaxW; ++w) {
          same = same && (w >= W || s_fo[buf][ii][w] == foj[w]);
        }
        if (!same) continue;
        const uint32_t* fi = s_f[buf][ii];
        uint32_t x = 0u;
#pragma unroll
        for (int w = 0; w < GW; ++w) x |= vmax_s16x2(fi[w], sj[w]) ^ sj[w];
        if (x != 0u) continue;  // not le_ij
        if (i < j) {
          killed = true;
          break;
        }
        // i later: j dies unless le_ji (tested only here, rarely)
        uint32_t y = 0u, si = 0u;
#pragma unroll
        for (int w = 0; w < GW; ++w) {
          y |= vmax_s16x2(fj[w], fi[w]) ^ fi[w];
          si |= fi[w];
        }
        if (!(capj && y == 0u && (si & 0x80008000u) == 0u)) {
          killed = true;
          break;
        }
      }
      done = killed;
    }
    if (!__syncthreads_or(!done)) break;
  }
  cp_async_wait<0>();
  if (killed) dead[lane0 + j] = 1;
}

// The prune for the shapes k_prune_tiles does not take (an odd G, G > 64
// or not a power of two, more than kPruneMaxW fok words): one thread per
// buffer row j scans its class list with scalar compares, the same test.
__global__ void k_prune_list(int Cb, int W, int G, int m, int S, int cb_shift,
                             const int32_t* __restrict__ nk0,
                             const int32_t* __restrict__ bst,
                             const uint32_t* __restrict__ bfo,
                             const int16_t* __restrict__ bfc,
                             const uint32_t* __restrict__ bcls,
                             const int32_t* __restrict__ coff,
                             const int32_t* __restrict__ ccnt,
                             const int32_t* __restrict__ list,
                             uint8_t* __restrict__ dead) {
  const int l = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= min(nk0[l], Cb)) return;
  const int64_t lane0 = static_cast<int64_t>(l) * Cb;
  const int64_t bj = lane0 + j;
  const int64_t sbi = static_cast<int64_t>(l) * S + (bcls[bj] >> cb_shift);
  const int32_t* lst = list + lane0 + coff[sbi];
  const int k = ccnt[sbi];
  const int32_t stj = bst[bj];
  bool killed = false;
  for (int t = 0; t < k && !killed; ++t) {
    const int i = lst[t];
    if (i == j) continue;
    const int64_t bi = lane0 + i;
    if (bst[bi] != stj) continue;
    bool same = true;
    for (int w = 0; w < W && same; ++w) same = bfo[bi * W + w] == bfo[bj * W + w];
    if (!same) continue;
    // le_ij: fcr_i <= sat(fcr_j) on every group; le_ji the reverse.  A
    // group counts only where the saturated count has a one-hot plane
    // (0 <= sat < m), as the matmul formulation counts it.
    bool le_ij = true, le_ji = true;
    for (int g = 0; g < G; ++g) {
      const int fi = bfc[bi * G + g];
      const int fj = bfc[bj * G + g];
      const int si = min(fi, m - 1);
      const int sj = min(fj, m - 1);
      if (!(sj >= 0 && fi <= sj)) le_ij = false;
      if (!(si >= 0 && fj <= si)) le_ji = false;
    }
    killed = le_ij && (!le_ji || i < j);
  }
  if (killed) dead[bj] = 1;
}

// The second compaction, over chunks of kChunkRows buffer rows.  Each
// block counts the lane's survivors before its chunk and in all (the
// lane's 2C dead flags, read by the whole block: no count or scan
// launch), scans its chunk's survivors to their output rows and copies
// them as whole words, hashes them into the fingerprint (per-warp
// partial sums added with unsigned atomics: mod 2^32, in any order), and
// zeroes the output rows of its span that no survivor fills.
__global__ void __launch_bounds__(kChunkRows)
    k_compact2(int Cb, int C, int W, int G, const int32_t* __restrict__ nk0,
               const int32_t* __restrict__ bst,
               const uint32_t* __restrict__ bfo,
               const int16_t* __restrict__ bfc,
               const uint8_t* __restrict__ bch,
               const uint8_t* __restrict__ dead,
               int32_t* __restrict__ kst, uint32_t* __restrict__ kfo,
               int16_t* __restrict__ kfc, uint8_t* __restrict__ alv,
               uint8_t* __restrict__ chd, uint8_t* __restrict__ ovf,
               uint64_t* __restrict__ fp) {
  __shared__ int32_t sidx[kChunkRows];
  const int l = blockIdx.y;
  const int r0 = blockIdx.x * kChunkRows;
  const int nv = min(nk0[l], Cb);
  const int64_t lane_b = static_cast<int64_t>(l) * Cb;
  const int64_t lane_c = static_cast<int64_t>(l) * C;
  int before = 0, all = 0;
  for (int r = threadIdx.x; r < nv; r += blockDim.x) {
    const int a = dead[lane_b + r] ? 0 : 1;
    all += a;
    if (r < r0) before += a;
  }
  block_exclusive_scan(before, &before);
  block_exclusive_scan(all, &all);
  const int r = r0 + threadIdx.x;
  const int a = (r < nv && !dead[lane_b + r]) ? 1 : 0;
  int tot;
  const int ex = block_exclusive_scan(a, &tot);
  if (a) sidx[ex] = r;
  __syncthreads();
  const int kc = max(0, min(tot, C - before));
  const int64_t o0 = lane_c + before;
  copy_rows(bst + lane_b, kst + o0, 4, sidx, kc);
  copy_rows(bfo + lane_b * W, kfo + o0 * W, 4 * W, sidx, kc);
  copy_rows(bfc + lane_b * G, kfc + o0 * G, 2 * G, sidx, kc);
  uint32_t s1 = 0u, s2 = 0u, sc = 0u;
  if (static_cast<int>(threadIdx.x) < kc) {
    const int64_t br = lane_b + sidx[threadIdx.x];
    alv[o0 + threadIdx.x] = 1;
    chd[o0 + threadIdx.x] = bch[br];
    row_hash(bst, bfo, bfc, br, W, G, kFpSeed1, kFpSeed2, s1, s2);
    sc = 1u;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, d);
    s2 += __shfl_down_sync(0xffffffffu, s2, d);
    sc += __shfl_down_sync(0xffffffffu, sc, d);
  }
  if ((threadIdx.x & 31) == 0 && sc != 0u) {
    // the low 32-bit half of each little-endian 64-bit word: the sums
    // wrap mod 2^32 and the high halves stay 0
    uint32_t* f32 = reinterpret_cast<uint32_t*>(fp + static_cast<int64_t>(l) * 3);
    atomicAdd(f32 + 0, s1);
    atomicAdd(f32 + 2, s2);
    atomicAdd(f32 + 4, sc);
  }
  const int z0 = max(min(all, C), r0);
  const int z1 = min(C, r0 + kChunkRows);
  if (z0 < z1) {
    const int64_t oz = lane_c + z0;
    zero_rows(kst + oz, 4, z1 - z0);
    zero_rows(kfo + oz * W, 4 * W, z1 - z0);
    zero_rows(kfc + oz * G, 2 * G, z1 - z0);
    zero_rows(alv + oz, 1, z1 - z0);
    zero_rows(chd + oz, 1, z1 - z0);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ovf[l] = (nk0[l] > Cb || all > C) ? 1 : 0;
  }
}

inline unsigned blocks_for(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

inline int scan_chunks(int E) { return (E + kScanChunk - 1) / kScanChunk; }

// int32 words of scratch wk_keep_mask needs for L lanes of n rows: two
// key buffers, two hash-pair buffers, the histograms (the first pass's,
// per hash sub-tile, is the largest) and the scan's chunk totals, each
// region rounded to 64 words.
inline int64_t round64(int64_t w) { return (w + 63) / 64 * 64; }

int64_t keep_scratch_words(int L, int n) {
  const int64_t ln = static_cast<int64_t>(L) * n;
  const int64_t E = kMaxBins * static_cast<int64_t>((n + kSortThreads - 1) / kSortThreads);
  return 2 * round64(ln) + 2 * round64(2 * ln) + round64(L * E) +
         round64(L * ((E + kScanChunk - 1) / kScanChunk));
}

}  // namespace

extern "C" {

int wk_chunk_rows() { return kChunkRows; }

const char* wk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int64_t wk_keep_scratch_words(int L, int n) { return keep_scratch_words(L, n); }

// Dedup keep mask over L lanes of n rows, with the packed key's bucket
// and index bits (bbits + ibits = 31).  scratch: wk_keep_scratch_words
// int32 words, 256-byte aligned.  Outputs: keep [L*n] and ovf [L] (0/1
// bytes), and, when chunk_cnt is not null, the kept count of each
// kChunkRows chunk [L * ceil(n / kChunkRows)].  No output needs zeroing
// by the caller.  Launches: the hash pass, then per digit pass (the
// first one's histogram comes from the hash pass) a histogram, a scan
// and a scatter, then the stencil and, for chunk_cnt, the count.
int wk_keep_mask(int L, int n, int W, int G, int window, int bbits, int ibits,
                 const void* state, const void* fok, const void* fcr,
                 const void* alive, void* scratch, void* keep, void* ovf,
                 void* chunk_cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bbits < 1 || ibits < 1 || bbits + ibits != 31 || n < 1 ||
      n > (1 << ibits) || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ln = static_cast<int64_t>(L) * n;
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  const int sub = (n + kSortThreads - 1) / kSortThreads;  // hash blocks a lane
  int32_t* w = static_cast<int32_t*>(scratch);
  uint32_t* kbuf[2] = {reinterpret_cast<uint32_t*>(w),
                       reinterpret_cast<uint32_t*>(w + round64(ln))};
  w += 2 * round64(ln);
  uint2* hbuf[2] = {reinterpret_cast<uint2*>(w),
                    reinterpret_cast<uint2*>(w + round64(2 * ln))};
  w += 2 * round64(2 * ln);
  int32_t* hist = w;
  const int64_t E = static_cast<int64_t>(kMaxBins) * sub;
  int32_t* csum = hist + round64(L * E);
  const bool aligned = reinterpret_cast<uintptr_t>(fcr) % 16 == 0;
  // the first pass sorts by the top digit of the bucket; each bin (one
  // top digit) is then sorted by the remaining bits in digits of rwidth
  const int tbits = std::min(kMaxDigitBits, std::max(1, bbits - kBinBits));
  const Digit top{ibits + bbits - tbits, 1 << tbits};
  const int rbits = bbits - tbits;
  const int rpasses = (rbits + kMaxDigitBits - 1) / kMaxDigitBits;
  const int rwidth = rpasses > 0 ? (rbits + rpasses - 1) / rpasses : 0;
#define WK_HASH_KEYS(K)                                                         \
  k_hash_keys<K><<<dim3(sub, L), kSortThreads, kSortThreads * 16 * K, s>>>(     \
      n, W, G, bbits, ibits, top, sub, static_cast<const int32_t*>(state),      \
      static_cast<const uint32_t*>(fok), static_cast<const int16_t*>(fcr),      \
      static_cast<const uint8_t*>(alive), hbuf[0], kbuf[0],                     \
      static_cast<uint8_t*>(keep), hist, static_cast<uint8_t*>(ovf))
  switch (aligned ? G : 0) {
    case 8: WK_HASH_KEYS(1); break;
    case 16: WK_HASH_KEYS(2); break;
    case 32: WK_HASH_KEYS(4); break;
    case 64: WK_HASH_KEYS(8); break;
    default: WK_HASH_KEYS(0);
  }
#undef WK_HASH_KEYS
  const int nch = scan_chunks(top.bins * sub);
  k_scan_hist<<<dim3(nch, L), kSortThreads, 0, s>>>(top.bins * sub, nch, hist, csum);
  k_radix_scatter<<<dim3(ntiles, L), kSortThreads, 0, s>>>(
      n, top, sub, nch, hist, csum, kbuf[0], hbuf[0],
      kbuf[1], hbuf[1]);
  const int groups = kItems * (kSortThreads / 32);
  k_bin_sort_kill<<<dim3(top.bins, L), kSortThreads,
                    rbits > 0 ? sizeof(int) * groups << rwidth : 0, s>>>(
      n, ibits, rbits, rwidth, window, sub, nch, hist, csum, kbuf[1], hbuf[1],
      kbuf[0], hbuf[0], static_cast<uint8_t*>(keep), static_cast<uint8_t*>(ovf));
  if (chunk_cnt != nullptr) {
    k_chunk_count<<<dim3((n + kChunkRows - 1) / kChunkRows, L), kChunkRows, 0, s>>>(
        n, static_cast<const uint8_t*>(keep), static_cast<int32_t*>(chunk_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused tail after wk_keep_mask (with chunk_cnt): compaction into
// the Cb = 2C buffer with the class partition, the domination prune,
// compaction to C rows and the fingerprint.  child [L*n] (0/1) is the
// explicit child column, or null for the positional one from n_parents
// (-1: no children); the two exclude each other.  S = 2^cbits class
// super-buckets per lane.  Scratch: nk0 [L], bst [L*Cb], bfo [L*Cb*W],
// bfc [L*Cb*G], bch and dead [L*Cb] bytes, bcls and clist [L*Cb], ccnt,
// coff and cursor [L*S].  Outputs: kst [L*C], kfo [L*C*W], kfc [L*C*G],
// alv, chd [L*C] and ovf [L] (0/1 bytes), fp [L*3] (64-bit words holding
// the uint32 sums).
int wk_fused_tail(int L, int n, int C, int W, int G, int m, int n_parents,
                  int cbits, const void* state, const void* fok,
                  const void* fcr, const void* child, const void* keep,
                  const void* chunk_cnt, void* nk0, void* bst, void* bfo,
                  void* bfc, void* bch, void* dead, void* bcls, void* clist,
                  void* ccnt, void* coff, void* cursor, void* kst, void* kfo,
                  void* kfc, void* alv, void* chd, void* ovf, void* fp,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((child != nullptr && n_parents >= 0) || cbits < 1 || cbits > 24) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using I = int32_t;
  using U = uint32_t;
  using B = uint8_t;
  const int Cb = 2 * C;
  const int S = 1 << cbits;
  const int cb_shift = 32 - cbits;
  const int nchunks = static_cast<int>(blocks_for(n, kChunkRows));
  const cudaError_t e = cudaMemsetAsync(ccnt, 0, sizeof(I) * static_cast<size_t>(L) * S, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  k_compact1<<<dim3(nchunks, L), kChunkRows, 0, s>>>(
      n, nchunks, Cb, W, G, n_parents, S, cb_shift, static_cast<const I*>(state),
      static_cast<const U*>(fok), static_cast<const int16_t*>(fcr),
      static_cast<const B*>(child), static_cast<const B*>(keep),
      static_cast<const I*>(chunk_cnt), static_cast<I*>(nk0), static_cast<I*>(bst),
      static_cast<U*>(bfo), static_cast<int16_t*>(bfc), static_cast<B*>(bch),
      static_cast<B*>(dead), static_cast<U*>(bcls), static_cast<I*>(ccnt),
      static_cast<uint64_t*>(fp));
  k_exclusive_scan<<<L, kScanThreads, 0, s>>>(
      S, static_cast<const I*>(ccnt), static_cast<I*>(coff),
      static_cast<I*>(cursor));
  const dim3 rows(blocks_for(Cb, kRowThreads), L);
  k_class_scatter<<<rows, kRowThreads, 0, s>>>(
      Cb, S, cb_shift, static_cast<const I*>(nk0), static_cast<const U*>(bcls),
      static_cast<I*>(cursor), static_cast<I*>(clist));
  const dim3 tiles(blocks_for(Cb, kPruneRows) * kPruneSplit, L);
#define WK_PRUNE_TILES(GW)                                                      \
  k_prune_tiles<GW><<<tiles, kPruneRows, 0, s>>>(                               \
      Cb, W, S, cb_shift, m, static_cast<const I*>(nk0),                        \
      static_cast<const I*>(bst), static_cast<const U*>(bfo),                   \
      static_cast<const int16_t*>(bfc), static_cast<const U*>(bcls),            \
      static_cast<const I*>(coff), static_cast<const I*>(ccnt),                 \
      static_cast<const I*>(clist), static_cast<B*>(dead))
  const int gw = (W <= kPruneMaxW && G % 2 == 0) ? G / 2 : 0;
  switch (gw) {
    case 2: WK_PRUNE_TILES(2); break;
    case 4: WK_PRUNE_TILES(4); break;
    case 8: WK_PRUNE_TILES(8); break;
    case 16: WK_PRUNE_TILES(16); break;
    case 32: WK_PRUNE_TILES(32); break;
    default:
      k_prune_list<<<rows, kRowThreads, 0, s>>>(
          Cb, W, G, m, S, cb_shift, static_cast<const I*>(nk0),
          static_cast<const I*>(bst), static_cast<const U*>(bfo),
          static_cast<const int16_t*>(bfc), static_cast<const U*>(bcls),
          static_cast<const I*>(coff), static_cast<const I*>(ccnt),
          static_cast<const I*>(clist), static_cast<B*>(dead));
  }
#undef WK_PRUNE_TILES
  k_compact2<<<dim3(blocks_for(Cb, kChunkRows), L), kChunkRows, 0, s>>>(
      Cb, C, W, G, static_cast<const I*>(nk0), static_cast<const I*>(bst),
      static_cast<const U*>(bfo), static_cast<const int16_t*>(bfc),
      static_cast<const B*>(bch), static_cast<const B*>(dead), static_cast<I*>(kst),
      static_cast<U*>(kfo), static_cast<int16_t*>(kfc), static_cast<B*>(alv),
      static_cast<B*>(chd), static_cast<B*>(ovf), static_cast<uint64_t*>(fp));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
