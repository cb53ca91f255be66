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
// The D send bases and the D receive bases come in as device arrays of
// pointers, so the shards need not share one allocation.  That is the
// form a cross-card exchange takes, with peer pointers in the same
// tables.
//
// What bounds it on this card: bytes.  It reads each send slot once and
// writes each receive slot once, 2 * D * D * rcap * NC * 4 bytes (145 MB
// at the bench rescue shape, D = 4, rcap = 31,488, NC = 36: 0.043 ms at
// 3.35 TB/s), with no arithmetic.  The design does the least a copy
// must: 16-byte vector loads and stores when a slot is a whole number of
// 16-byte words (rcap * NC a multiple of 4: always so at the engine's
// 128-row padded rcap, and row by row at the bench shapes, NC = 36 and
// 20), 4-byte ones otherwise; neighbouring threads on neighbouring
// addresses, and enough blocks per slot to cover the card.
//
// C interface for ctypes: launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Vector elements each thread copies, at most, in a slot's chunk.
constexpr int kPerThread = 4;
constexpr int64_t kMaxChunks = 65535;

template <typename T>
__global__ void k_exchange(int D, int64_t n, const T* const* __restrict__ send,
                           T* const* __restrict__ recv) {
  const int s = blockIdx.y;
  const int me = blockIdx.z;
  const T* __restrict__ src = send[me] + static_cast<int64_t>(s) * n;
  T* __restrict__ dst = recv[(me + s) % D] + static_cast<int64_t>(s) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    dst[i] = src[i];
  }
}

template <typename T>
cudaError_t launch(int D, int64_t n, const void* send, const void* recv,
                   cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPerThread;
  int64_t chunks = (n + per_block - 1) / per_block;
  if (chunks < 1) chunks = 1;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  const dim3 grid(static_cast<unsigned>(chunks), D, D);
  k_exchange<T><<<grid, kThreads, 0, stream>>>(
      D, n, static_cast<const T* const*>(send), static_cast<T* const*>(recv));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Exchange the [D, rcap, NC] int32 slot matrices of D shards: recv bases
// [(me + s) % D] slot s <- send bases [me] slot s.  slot_words =
// rcap * NC int32 per slot; send_bases and recv_bases are device arrays
// of D pointers each, every pointer 16-byte aligned when slot_words is a
// multiple of 4 (the caller checks).  Returns cudaGetLastError().
int wk_mesh_exchange(int D, int64_t slot_words, const void* send_bases,
                     const void* recv_bases, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 65535 || slot_words < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slot_words == 0) return static_cast<int>(cudaGetLastError());
  if (slot_words % 4 == 0) {
    return static_cast<int>(launch<int4>(D, slot_words / 4, send_bases, recv_bases, s));
  }
  return static_cast<int>(launch<int32_t>(D, slot_words, send_bases, recv_bases, s));
}

}  // extern "C"
