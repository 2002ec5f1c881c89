// stream_extract: stream compaction of kept cells into capacity rows.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_extract.py:stream_extract_z2
// (both _extract_kernel and _extract_kernel_sepk: one meaning, so one
// kernel here).  Given keep [n] in flat (x, z, y) order and a payload
// [n, E] of 2-byte elements, it returns
//   src[j]   = flat index of the j-th kept cell, ascending, for j < cap
//   vals[j]  = payload[src[j]]
//   valid[j] = j < min(total, cap)
//   total    = number of kept cells before the capacity clamp
// and zero rows beyond min(total, cap) (the wrapper zero-fills the
// outputs).  This is the flat-index order of the reference's compact_src,
// so the port's extraction sets AND row order equal the XLA path's.
//
// The TPU kernel relied on its grid running blocks in order, each block
// overwriting the previous block's garbage tail.  CUDA blocks run
// concurrently, so this kernel computes a real prefix sum:
//   1. count: each block counts its 1024 cells' keep bits (warp ballot +
//      __popc, per-warp sums in shared memory);
//   2. scan: one block turns the per-block counts into exclusive offsets
//      and the total;
//   3. rank: each block recomputes its ballots, adds the block offset and
//      the in-block prefix, and writes src/valid for ranks below cap;
//   4. gather: one thread per output element copies the payload row.
// What bounds it on an H100: bytes.  At the stride-1 shape keep is ~4 MB
// (read twice) and the payload rows moved are <= cap * E * 2 bytes; all of
// it is a few tens of microseconds of HBM time, so the design keeps every
// access coalesced and does no atomics.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROUNDS = 4;
constexpr int CELLS = THREADS * ROUNDS;   // cells per block
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS) count_kernel(
    const uint8_t* __restrict__ keep, long long n, int* __restrict__ counts) {
  __shared__ int warp_sum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mine = 0;
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = (long long)blockIdx.x * CELLS + r * THREADS + threadIdx.x;
    const bool k = i < n && keep[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, k);
    if (lane == 0) mine += __popc(ballot);
  }
  if (lane == 0) warp_sum[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < WARPS; ++w) s += warp_sum[w];
    counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(1024) scan_kernel(
    const int* __restrict__ counts, int nb, int* __restrict__ offsets,
    int* __restrict__ total) {
  __shared__ int sums[1024];
  const int t = threadIdx.x;
  const int per = (nb + 1023) / 1024;
  const int b0 = t * per;
  int s = 0;
  for (int b = b0; b < b0 + per && b < nb; ++b) s += counts[b];
  sums[t] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan of the 1024 thread sums.
  for (int d = 1; d < 1024; d <<= 1) {
    const int v = t >= d ? sums[t - d] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - s;   // exclusive prefix of this thread's chunk
  for (int b = b0; b < b0 + per && b < nb; ++b) {
    offsets[b] = run;
    run += counts[b];
  }
  if (t == 1023) *total = sums[1023];
}

__global__ void __launch_bounds__(THREADS) rank_kernel(
    const uint8_t* __restrict__ keep, long long n, int cap,
    const int* __restrict__ offsets, int* __restrict__ src,
    uint8_t* __restrict__ valid) {
  __shared__ int warp_cnt[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = offsets[blockIdx.x];
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = (long long)blockIdx.x * CELLS + r * THREADS + threadIdx.x;
    const bool k = i < n && keep[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, k);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round_total = 0;
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? warp_cnt[w] : 0;
      round_total += warp_cnt[w];
    }
    if (k) {
      const int rank = base + before + __popc(ballot & ((1u << lane) - 1u));
      if (rank < cap) {
        src[rank] = (int)i;
        valid[rank] = 1;
      }
    }
    base += round_total;
    __syncthreads();
  }
}

__global__ void gather_kernel(const unsigned short* __restrict__ payload,
                              int E, int cap, const int* __restrict__ src,
                              const int* __restrict__ total,
                              unsigned short* __restrict__ vals) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int rows = min(*total, cap);
  if (e >= (long long)rows * E) return;
  const long long row = e / E;
  const int col = (int)(e % E);
  vals[e] = payload[(long long)src[row] * E + col];
}

}  // namespace

extern "C" int pasco_stream_extract(
    const void* keep, const void* payload, long long n, int E, int cap,
    void* block_counts, void* block_offsets, void* vals, void* src,
    void* valid, void* total, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (int)((n + CELLS - 1) / CELLS);
  if (nb == 0) return (int)cudaErrorInvalidValue;
  count_kernel<<<nb, THREADS, 0, s>>>((const uint8_t*)keep, n, (int*)block_counts);
  scan_kernel<<<1, 1024, 0, s>>>((const int*)block_counts, nb,
                                 (int*)block_offsets, (int*)total);
  rank_kernel<<<nb, THREADS, 0, s>>>((const uint8_t*)keep, n, cap,
                                     (const int*)block_offsets, (int*)src,
                                     (uint8_t*)valid);
  if (E > 0 && cap > 0) {
    const long long elems = (long long)cap * E;
    const int blocks = (int)((elems + 255) / 256);
    gather_kernel<<<blocks, 256, 0, s>>>((const unsigned short*)payload, E,
                                         cap, (const int*)src,
                                         (const int*)total,
                                         (unsigned short*)vals);
  }
  return (int)cudaGetLastError();
}
