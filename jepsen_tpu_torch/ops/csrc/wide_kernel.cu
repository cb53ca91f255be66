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
// shared memory, but a 16-lane sub-batch (~110 MB) streams through HBM
// once per pass and the per-lane scratch (hashes, bucket lists) sits in
// the 50 MB L2.  The dedup passes are bound by bytes moved; the
// domination prune on the 2C = 4096-row buffer is an all-pairs integer
// compare (up to 1.7e7 pairs per lane), bound by operations.
//
// Design (what the Pallas kernel computes, not how it tiled VMEM):
//   The Pallas kernel is one sequential grid sweep with every table in
//   VMEM and an O(n^2) all-pairs bucket-rank sweep.  Hopper's blocks run
//   unordered, so each phase is its own grid over (rows, lanes), and the
//   all-pairs sweep becomes a bucket partition:
//   1. k_hash_count: two murmur fmix32 row-hash lanes per row (the JAX
//      package's hash_rows fold), and a histogram of alive rows per
//      (lane, super-bucket) with atomics.  A super-bucket is the top
//      sbits bits of h1 (sbits <= the packed key's bucket bits), so rows
//      of one bucket share one super-bucket.
//   2. k_exclusive_scan: per-lane exclusive scan of the histogram.
//   3. k_scatter: row indices into their super-bucket's slot list
//      (atomic cursor; the order inside a list is arbitrary).
//   4. k_pre: pre[i] = number of alive rows j < i in i's bucket (the
//      bucket prefix rank of _keep_bucket), by scanning i's short list.
//   5. k_kill: i dies iff an alive j < i in its list has both hash lanes
//      equal and pre[i] - pre[j] <= window.  Both scans read the list in
//      any order, so the result is deterministic without sorting it.
//      Each block also counts its kept rows (__syncthreads_count) for
//      the compaction.
//   Fused tail:
//   6. k_exclusive_scan over the per-block kept counts: block offsets.
//   7. k_compact1: stable block scan (warp shuffles) of the keep mask;
//      survivors go to the 2C buffer in candidate order, with their
//      child bit (an explicit column on the mesh path, else positional).
//   8. k_prune: one thread per buffer row j tests every alive row i:
//      same (state, fok) class, fcr_i <= min(fcr_j, m-1) on every group
//      (the saturating one-hot contract of exact_prune_mxu, as integer
//      compares), and (not the reverse, or i earlier).
//   9. k_compact2: one block per lane scans the buffer's survivors to
//      the capacity-row output, zero-fills dead rows, and sums the
//      order-insensitive fingerprint (mod 2^32, unsigned atomics wrap).
//
// C interface for ctypes: every entry point launches on the caller's
// stream, allocates nothing (the caller passes every buffer), does not
// synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kHashSeed1 = 0x0B00B135u;
constexpr uint32_t kHashSeed2 = 0x1CEB00DAu;
constexpr uint32_t kFpSeed1 = 0xFEED0001u;
constexpr uint32_t kFpSeed2 = 0xFEED0002u;
constexpr uint32_t kGolden = 0x9E3779B9u;

// Rows per block of the kill and first compaction passes (one row per
// thread); the Python wrapper sizes the per-block count table with it.
constexpr int kChunkRows = 512;
constexpr int kRowThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
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

// ---------------------------------------------------------------------------
// Dedup (keep mask)
// ---------------------------------------------------------------------------

__global__ void k_hash_count(int n, int W, int G, int S, int sb_shift,
                             const int32_t* __restrict__ state,
                             const uint32_t* __restrict__ fok,
                             const int16_t* __restrict__ fcr,
                             const uint8_t* __restrict__ alive,
                             uint32_t* __restrict__ h1,
                             uint32_t* __restrict__ h2,
                             int32_t* __restrict__ cnt) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r = static_cast<int64_t>(l) * n + i;
  uint32_t a, b;
  row_hash(state, fok, fcr, r, W, G, kHashSeed1, kHashSeed2, a, b);
  h1[r] = a;
  h2[r] = b;
  if (alive[r]) atomicAdd(&cnt[static_cast<int64_t>(l) * S + (a >> sb_shift)], 1);
}

// Per-lane exclusive scan of in[l, 0..S) into out (and out2 when given);
// total[l] gets the lane's sum when given.  One block per lane.
__global__ void k_exclusive_scan(int S, const int32_t* __restrict__ in,
                                 int32_t* __restrict__ out,
                                 int32_t* __restrict__ out2,
                                 int32_t* __restrict__ total) {
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
  if (total != nullptr && threadIdx.x == 0) total[blockIdx.x] = carry;
}

__global__ void k_scatter(int n, int S, int sb_shift,
                          const uint32_t* __restrict__ h1,
                          const uint8_t* __restrict__ alive,
                          int32_t* __restrict__ cursor,
                          int32_t* __restrict__ list) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r = static_cast<int64_t>(l) * n + i;
  if (!alive[r]) return;
  const int slot = atomicAdd(&cursor[static_cast<int64_t>(l) * S + (h1[r] >> sb_shift)], 1);
  list[static_cast<int64_t>(l) * n + slot] = i;
}

__global__ void k_pre(int n, int S, int sb_shift, int b_shift,
                      const uint32_t* __restrict__ h1,
                      const uint8_t* __restrict__ alive,
                      const int32_t* __restrict__ off,
                      const int32_t* __restrict__ cnt,
                      const int32_t* __restrict__ list,
                      int32_t* __restrict__ pre) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t lane0 = static_cast<int64_t>(l) * n;
  const int64_t r = lane0 + i;
  if (!alive[r]) return;
  const uint32_t a = h1[r];
  const uint32_t bucket = a >> b_shift;
  const int64_t sbi = static_cast<int64_t>(l) * S + (a >> sb_shift);
  const int32_t* lst = list + lane0 + off[sbi];
  const int k = cnt[sbi];
  int p = 0;
  for (int t = 0; t < k; ++t) {
    const int j = lst[t];
    if (j < i && (h1[lane0 + j] >> b_shift) == bucket) ++p;
  }
  pre[r] = p;
}

__global__ void k_kill(int n, int S, int sb_shift, int window,
                       const uint32_t* __restrict__ h1,
                       const uint32_t* __restrict__ h2,
                       const uint8_t* __restrict__ alive,
                       const int32_t* __restrict__ off,
                       const int32_t* __restrict__ cnt,
                       const int32_t* __restrict__ list,
                       const int32_t* __restrict__ pre,
                       uint8_t* __restrict__ keep,
                       int32_t* __restrict__ ovf,
                       int32_t* __restrict__ chunk_cnt) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t lane0 = static_cast<int64_t>(l) * n;
  int kept = 0;
  if (i < n) {
    const int64_t r = lane0 + i;
    if (alive[r]) {
      const uint32_t a = h1[r];
      const uint32_t b = h2[r];
      const int p = pre[r];
      const int64_t sbi = static_cast<int64_t>(l) * S + (a >> sb_shift);
      const int32_t* lst = list + lane0 + off[sbi];
      const int k = cnt[sbi];
      bool dup = false;
      for (int t = 0; t < k && !dup; ++t) {
        const int j = lst[t];
        if (j < i) {
          const int64_t rj = lane0 + j;
          dup = h1[rj] == a && h2[rj] == b && p - pre[rj] <= window;
        }
      }
      kept = dup ? 0 : 1;
      if (kept && p >= window) atomicOr(&ovf[l], 1);
    }
    keep[r] = static_cast<uint8_t>(kept);
  }
  if (chunk_cnt != nullptr) {
    const int c = __syncthreads_count(kept);
    if (threadIdx.x == 0) chunk_cnt[static_cast<int64_t>(l) * gridDim.x + blockIdx.x] = c;
  }
}

// ---------------------------------------------------------------------------
// Fused tail: compaction to the 2C buffer, domination prune, compaction
// to capacity with the fingerprint
// ---------------------------------------------------------------------------

// A survivor's child bit: the explicit child column when given (the mesh
// path, whose routing scrambled candidate order), else positional (rows
// at or past n_parents are expansions; none when n_parents < 0).
__global__ void k_compact1(int n, int Cb, int W, int G, int n_parents,
                           const int32_t* __restrict__ state,
                           const uint32_t* __restrict__ fok,
                           const int16_t* __restrict__ fcr,
                           const uint8_t* __restrict__ child,
                           const uint8_t* __restrict__ keep,
                           const int32_t* __restrict__ chunk_off,
                           int32_t* __restrict__ bst,
                           uint32_t* __restrict__ bfo,
                           int16_t* __restrict__ bfc,
                           uint8_t* __restrict__ bch) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = static_cast<int64_t>(l) * n + i;
  const int k = (i < n) ? keep[r] : 0;
  int tot;
  const int ex = block_exclusive_scan(k, &tot);
  const int rank = chunk_off[static_cast<int64_t>(l) * gridDim.x + blockIdx.x] + ex;
  if (k && rank < Cb) {
    const int64_t o = static_cast<int64_t>(l) * Cb + rank;
    bst[o] = state[r];
    for (int w = 0; w < W; ++w) bfo[o * W + w] = fok[r * W + w];
    for (int g = 0; g < G; ++g) bfc[o * G + g] = fcr[r * G + g];
    bch[o] = (child != nullptr)
                 ? static_cast<uint8_t>(child[r] != 0)
                 : static_cast<uint8_t>(n_parents >= 0 && i >= n_parents);
  }
}

__global__ void k_prune(int Cb, int W, int G, int m,
                        const int32_t* __restrict__ nk0,
                        const int32_t* __restrict__ bst,
                        const uint32_t* __restrict__ bfo,
                        const int16_t* __restrict__ bfc,
                        uint8_t* __restrict__ dead) {
  const int l = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int nv = min(nk0[l], Cb);
  if (j >= nv) return;
  const int64_t lane0 = static_cast<int64_t>(l) * Cb;
  const int64_t bj = lane0 + j;
  const int32_t sj = bst[bj];
  bool killed = false;
  for (int i = 0; i < nv && !killed; ++i) {
    if (i == j) continue;
    const int64_t bi = lane0 + i;
    if (bst[bi] != sj) continue;
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
      const int sj2 = min(fj, m - 1);
      if (!(sj2 >= 0 && fi <= sj2)) le_ij = false;
      if (!(si >= 0 && fj <= si)) le_ji = false;
    }
    killed = le_ij && (!le_ji || i < j);
  }
  dead[bj] = static_cast<uint8_t>(killed);
}

__global__ void k_compact2(int Cb, int C, int W, int G,
                           const int32_t* __restrict__ nk0,
                           const int32_t* __restrict__ bst,
                           const uint32_t* __restrict__ bfo,
                           const int16_t* __restrict__ bfc,
                           const uint8_t* __restrict__ bch,
                           const uint8_t* __restrict__ dead,
                           int32_t* __restrict__ kst,
                           uint32_t* __restrict__ kfo,
                           int16_t* __restrict__ kfc,
                           uint8_t* __restrict__ alv,
                           uint8_t* __restrict__ chd,
                           int32_t* __restrict__ flags,
                           uint32_t* __restrict__ fp) {
  __shared__ uint32_t acc[3];
  const int l = blockIdx.x;
  const int nv = min(nk0[l], Cb);
  const int64_t lane_b = static_cast<int64_t>(l) * Cb;
  const int64_t lane_c = static_cast<int64_t>(l) * C;
  if (threadIdx.x < 3) acc[threadIdx.x] = 0u;
  __syncthreads();
  uint32_t s1 = 0u, s2 = 0u, sc = 0u;
  int carry = 0;
  for (int r0 = 0; r0 < Cb; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    const int64_t br = lane_b + r;
    const int a = (r < nv && !dead[br]) ? 1 : 0;
    int tot;
    const int ex = block_exclusive_scan(a, &tot);
    const int rank = carry + ex;
    if (a && rank < C) {
      const int64_t o = lane_c + rank;
      kst[o] = bst[br];
      for (int w = 0; w < W; ++w) kfo[o * W + w] = bfo[br * W + w];
      for (int g = 0; g < G; ++g) kfc[o * G + g] = bfc[br * G + g];
      alv[o] = 1;
      chd[o] = bch[br];
      uint32_t f1, f2;
      row_hash(bst, bfo, bfc, br, W, G, kFpSeed1, kFpSeed2, f1, f2);
      s1 += f1;
      s2 += f2;
      sc += 1u;
    }
    carry += tot;
  }
  const int nk = carry;
  const int nkc = min(nk, C);
  for (int r = nkc + threadIdx.x; r < C; r += blockDim.x) {
    const int64_t o = lane_c + r;
    kst[o] = 0;
    for (int w = 0; w < W; ++w) kfo[o * W + w] = 0u;
    for (int g = 0; g < G; ++g) kfc[o * G + g] = 0;
    alv[o] = 0;
    chd[o] = 0;
  }
  atomicAdd(&acc[0], s1);
  atomicAdd(&acc[1], s2);
  atomicAdd(&acc[2], sc);
  __syncthreads();
  if (threadIdx.x == 0) {
    fp[static_cast<int64_t>(l) * 3 + 0] = acc[0];
    fp[static_cast<int64_t>(l) * 3 + 1] = acc[1];
    fp[static_cast<int64_t>(l) * 3 + 2] = acc[2];
    flags[static_cast<int64_t>(l) * 2 + 0] = (nk0[l] > Cb || nk > C) ? 1 : 0;
    flags[static_cast<int64_t>(l) * 2 + 1] = nk;
  }
}

inline unsigned blocks_for(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace

extern "C" {

int wk_chunk_rows() { return kChunkRows; }

const char* wk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dedup keep mask over L lanes of n rows.  S = 2^sbits super-buckets,
// bbits = the packed key's bucket bits (sbits <= bbits).  Scratch:
// h1, h2, list, pre [L*n]; cnt, off, cursor [L*S] with cnt zeroed.
// Outputs: keep [L*n] (0/1), ovf [L] (zeroed by the caller), and, when
// chunk_cnt is not null, the kept count of each kChunkRows block
// [L * ceil(n / kChunkRows)].
int wk_keep_mask(int L, int n, int W, int G, int window, int sbits,
                 int bbits, const void* state, const void* fok,
                 const void* fcr, const void* alive, void* h1, void* h2,
                 void* cnt, void* off, void* cursor, void* list, void* pre,
                 void* keep, void* ovf, void* chunk_cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = 1 << sbits;
  const int sb_shift = 32 - sbits;
  const int b_shift = 32 - bbits;
  const dim3 rows(blocks_for(n, kRowThreads), L);
  k_hash_count<<<rows, kRowThreads, 0, s>>>(
      n, W, G, S, sb_shift, static_cast<const int32_t*>(state),
      static_cast<const uint32_t*>(fok), static_cast<const int16_t*>(fcr),
      static_cast<const uint8_t*>(alive), static_cast<uint32_t*>(h1),
      static_cast<uint32_t*>(h2), static_cast<int32_t*>(cnt));
  k_exclusive_scan<<<L, kScanThreads, 0, s>>>(
      S, static_cast<const int32_t*>(cnt), static_cast<int32_t*>(off),
      static_cast<int32_t*>(cursor), nullptr);
  k_scatter<<<rows, kRowThreads, 0, s>>>(
      n, S, sb_shift, static_cast<const uint32_t*>(h1),
      static_cast<const uint8_t*>(alive), static_cast<int32_t*>(cursor),
      static_cast<int32_t*>(list));
  k_pre<<<rows, kRowThreads, 0, s>>>(
      n, S, sb_shift, b_shift, static_cast<const uint32_t*>(h1),
      static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(list),
      static_cast<int32_t*>(pre));
  const dim3 chunks(blocks_for(n, kChunkRows), L);
  k_kill<<<chunks, kChunkRows, 0, s>>>(
      n, S, sb_shift, window, static_cast<const uint32_t*>(h1),
      static_cast<const uint32_t*>(h2), static_cast<const uint8_t*>(alive),
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(cnt),
      static_cast<const int32_t*>(list), static_cast<const int32_t*>(pre),
      static_cast<uint8_t*>(keep), static_cast<int32_t*>(ovf),
      static_cast<int32_t*>(chunk_cnt));
  return static_cast<int>(cudaGetLastError());
}

// The fused tail after wk_keep_mask (with chunk_cnt): compaction into
// the Cb = 2C buffer, the domination prune, compaction to C rows and the
// fingerprint.  child [L*n] (0/1) is the explicit child column, or null
// for the positional one from n_parents (-1: no children); the two
// exclude each other.  Scratch: chunk_off [L*nchunks], nk0 [L], bst
// [L*Cb], bfo [L*Cb*W], bfc [L*Cb*G], bch, dead [L*Cb].  Outputs: kst
// [L*C], kfo [L*C*W], kfc [L*C*G], alv, chd [L*C], flags [L*2]
// (overflowed, survivor count), fp [L*3].
int wk_fused_tail(int L, int n, int C, int W, int G, int m, int n_parents,
                  const void* state, const void* fok, const void* fcr,
                  const void* child,
                  const void* keep, const void* chunk_cnt, void* chunk_off,
                  void* nk0, void* bst, void* bfo, void* bfc, void* bch,
                  void* dead, void* kst, void* kfo, void* kfc, void* alv,
                  void* chd, void* flags, void* fp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (child != nullptr && n_parents >= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Cb = 2 * C;
  const int nchunks = static_cast<int>(blocks_for(n, kChunkRows));
  k_exclusive_scan<<<L, kScanThreads, 0, s>>>(
      nchunks, static_cast<const int32_t*>(chunk_cnt),
      static_cast<int32_t*>(chunk_off), nullptr, static_cast<int32_t*>(nk0));
  const dim3 chunks(nchunks, L);
  k_compact1<<<chunks, kChunkRows, 0, s>>>(
      n, Cb, W, G, n_parents, static_cast<const int32_t*>(state),
      static_cast<const uint32_t*>(fok), static_cast<const int16_t*>(fcr),
      static_cast<const uint8_t*>(child), static_cast<const uint8_t*>(keep),
      static_cast<const int32_t*>(chunk_off), static_cast<int32_t*>(bst),
      static_cast<uint32_t*>(bfo), static_cast<int16_t*>(bfc),
      static_cast<uint8_t*>(bch));
  const dim3 buf(blocks_for(Cb, kRowThreads), L);
  k_prune<<<buf, kRowThreads, 0, s>>>(
      Cb, W, G, m, static_cast<const int32_t*>(nk0),
      static_cast<const int32_t*>(bst), static_cast<const uint32_t*>(bfo),
      static_cast<const int16_t*>(bfc), static_cast<uint8_t*>(dead));
  k_compact2<<<L, kScanThreads, 0, s>>>(
      Cb, C, W, G, static_cast<const int32_t*>(nk0),
      static_cast<const int32_t*>(bst), static_cast<const uint32_t*>(bfo),
      static_cast<const int16_t*>(bfc), static_cast<const uint8_t*>(bch),
      static_cast<const uint8_t*>(dead), static_cast<int32_t*>(kst),
      static_cast<uint32_t*>(kfo), static_cast<int16_t*>(kfc),
      static_cast<uint8_t*>(alv), static_cast<uint8_t*>(chd),
      static_cast<int32_t*>(flags), static_cast<uint32_t*>(fp));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
