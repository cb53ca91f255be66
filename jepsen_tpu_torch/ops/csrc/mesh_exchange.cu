// The mesh exchange for Hopper (sm_90a): the all-to-all of the
// pre-rotated slot matrices of D logical shards on one card.
//
// Replaces the Pallas TPU kernel of jepsen_tpu/ops/wide_kernel.py:
//   * _exchange_kernel (:873), called by mesh_exchange (:902)
//     -> wk_mesh_exchange
//
// What it computes.  Shard `me` holds a send matrix [D, rcap, NC] of
// int32 whose slot s is the bucket it routed to shard (me + s) % D.  The
// TPU kernel starts one remote DMA per slot (slot 0 a local copy) and
// waits on paired semaphores, so that the receiver's slot s holds the
// rows from source (me - s) % D.  Here every shard lies on one card, so
// the ring's stores are one copy kernel: block (chunk, s, me) copies its
// chunk of send[me][s] to recv[(me + s) % D][s].  There is nothing to
// wait on between shards, so no semaphores are translated; the launch
// on the caller's stream orders the exchange after the routing scatter
// and before the consumer.
//
// The D send bases and the D receive bases travel by value, in one
// kernel parameter (struct Bases, 2 * kMaxShards pointers = 1 KB of the
// 4 KB parameter space), so the shards need not share one allocation
// and a call is one launch with no host-to-device copy.  That is the
// form a cross-card exchange takes, with peer pointers in the same
// struct.
//
// What bounds it on this card: bytes.  It reads each send slot once and
// writes each receive slot once, 2 * D * D * rcap * NC * 4 bytes (145 MB
// at the bench rescue shape, D = 4, rcap = 31,488, NC = 36: 0.0433 ms at
// 3.35 TB/s; 49 MB and 0.0147 ms at rcap = 19,200, NC = 20), with no
// arithmetic, and 145 MB does not fit the 50 MB L2.  So the design keeps
// as many bytes in flight as HBM needs and keeps the copy out of the
// caches: each thread issues kUnroll independent 16-byte streaming loads
// (ld.global.cs, __ldcs) before its kUnroll streaming stores (__stcs);
// neighbouring threads touch neighbouring 16-byte words; and the grid
// is a few waves of the card's SMs (kWaves), not one block per chunk of
// the slot, with a grid-stride loop over the rest.  A slot that is not
// a whole number of 16-byte words (rcap * NC not a multiple of 4) takes
// the same loop with 4-byte words.  Measured (chip_smoke.py; NVIDIA
// H100 80GB HBM3, 700 W), on the card alone: 0.053 ms at the G = 32
// shape (82 % of the byte bound's rate) and 0.016 ms at G = 16, where
// part of the 49 MB stays in the 50 MB L2 between back-to-back calls.
//
// C interface for ctypes: launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
// Independent vector loads each thread keeps in flight before storing.
constexpr int kUnroll = 4;
// Resident blocks per SM at kThreads (2048 threads per SM), and the
// waves of them one exchange is sized to.
constexpr int kBlocksPerSm = 8;
constexpr int kWaves = 4;
constexpr int64_t kMaxChunks = 65535;

struct Bases {
  const void* send[kMaxShards];
  void* recv[kMaxShards];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_exchange(int D, int64_t n, const __grid_constant__ Bases b) {
  const int s = blockIdx.y;
  const int me = blockIdx.z;
  const T* __restrict__ src =
      static_cast<const T*>(b.send[me]) + static_cast<int64_t>(s) * n;
  T* __restrict__ dst =
      static_cast<T*>(b.recv[(me + s) % D]) + static_cast<int64_t>(s) * n;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       i0 < n; i0 += step) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + static_cast<int64_t>(u) * kThreads;
      if (i < n) v[u] = __ldcs(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + static_cast<int64_t>(u) * kThreads;
      if (i < n) __stcs(dst + i, v[u]);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms < 1) {
      sms = 132;
    }
  }
  return sms;
}

template <typename T>
cudaError_t launch(int D, int64_t n, const Bases& b, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t slots = static_cast<int64_t>(D) * D;
  // Blocks per slot: kWaves waves of the card over all D * D slots.
  const int64_t cap = (static_cast<int64_t>(kWaves) * kBlocksPerSm * sm_count() + slots - 1) / slots;
  int64_t chunks = (n + per_block - 1) / per_block;
  if (chunks > cap) chunks = cap;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  if (chunks < 1) chunks = 1;
  const dim3 grid(static_cast<unsigned>(chunks), D, D);
  k_exchange<T><<<grid, kThreads, 0, stream>>>(D, n, b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Exchange the [D, rcap, NC] int32 slot matrices of D shards: recv bases
// [(me + s) % D] slot s <- send bases [me] slot s.  slot_words =
// rcap * NC int32 per slot.  send_bases and recv_bases are HOST arrays
// of D device pointers each (copied into the launch's parameter), every
// pointer 16-byte aligned when slot_words is a multiple of 4 (the
// caller checks); D <= kMaxShards.  Returns cudaGetLastError().
int wk_mesh_exchange(int D, int64_t slot_words, const void* const* send_bases,
                     void* const* recv_bases, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > kMaxShards || slot_words < 0 || send_bases == nullptr ||
      recv_bases == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slot_words == 0) return static_cast<int>(cudaGetLastError());
  Bases b = {};
  for (int m = 0; m < D; ++m) {
    b.send[m] = send_bases[m];
    b.recv[m] = recv_bases[m];
  }
  if (slot_words % 4 == 0) {
    return static_cast<int>(launch<int4>(D, slot_words / 4, b, s));
  }
  return static_cast<int>(launch<int>(D, slot_words, b, s));
}

}  // extern "C"
