// stream_extract: stream compaction of kept cells into capacity rows, in
// one launch.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_extract.py:stream_extract_z2
// (both _extract_kernel and _extract_kernel_sepk: one meaning, so one
// kernel here).  Given keep [n] in flat (x, z, y) order and a payload
// [n, E] of 2-byte elements, it writes
//   src[j]   = flat index of the j-th kept cell, ascending, for j < cap
//   vals[j]  = payload[src[j]]
//   valid[j] = j < min(total, cap)
//   total    = number of kept cells before the capacity clamp
// and zero rows in [min(total, cap), cap): every byte of the outputs is
// written by the kernel, so the wrapper allocates them uninitialised.
// This is the flat-index order of the reference's compact_src, so the
// port's extraction sets AND row order equal the XLA path's.
//
// The TPU kernel relied on its grid running blocks in order, each block
// overwriting the previous block's garbage tail.  CUDA blocks run
// concurrently, so this kernel is a single-pass prefix sum with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016), fused with the gather, in one cooperative
// launch (all CTAs co-resident, which the launch guarantees or refuses):
//   1. CTA b of the grid (as many CTAs as fit on the card at once) takes
//      tiles b, b + grid, ... (TILE cells each), in order; it
//      reads a tile's keep bytes once (16-byte loads), counts them and
//      publishes the tile's aggregate in flags[tile];
//   2. it ranks the kept cells inside the tile (warp scan + per-warp sums)
//      into a shared list, while warp 0 walks back over the predecessors'
//      flags, 128 at a time, until an inclusive prefix closes the sum; it
//      then publishes the tile's inclusive prefix and writes src/valid of
//      the ranks below cap from the shared list (coalesced; the list is
//      padded so that a dense keep's writes miss no bank);
//   3. after its own tiles, a CTA takes an even share [a0, a1) of the cap
//      rows (split by rows, not by tiles: when the cap binds, the kept rows
//      sit in the first tiles, whose CTAs alone would copy all of them);
//      warp 0 waits until every tile whose ranks start below a1 is done
//      (a third flag status, set after the tile's src/valid are written),
//      which also gives min(total, a1);
//   4. it copies the payload rows of its share below the total (src read
//      back from L2, the widest vector that divides a row, a group of lanes
//      per row: no division per element, four rows in flight per lane
//      group) and zeroes the rest of its share.  The CTA of the last tile
//      writes total.
// No wait can block: a CTA waits only for tiles of co-resident CTAs, and
// the lowest tile in work has all its predecessors done.
//
// Scratch without a memset per call: each flag word holds the call's
// epoch (high 32 bits, passed by the wrapper, new for every call on the
// workspace), a status (bits 30-31: 1 aggregate, 2 inclusive prefix, 3
// inclusive prefix with the tile's rows written) and the value (bits 0-29; the wrapper keeps n < 2^30).  A word of another
// epoch reads as "not yet published".
//
// What bounds it on an H100: bytes.  keep is read once (~4 MB at the
// stride-1 box), each kept payload row read once and every output byte
// written once; at those sizes the single launch also removes the three
// extra launches and four memsets of a count/scan/rank/gather design.
#include "common.cuh"

#ifndef EXTRACT_ABLATE
#define EXTRACT_ABLATE 0   // scripts_torch/extract_ablation.py; 0 in the model's build
#endif

namespace {

constexpr int THREADS = 1024;          // large tiles: a short look-back chain
constexpr int WARPS = THREADS / 32;
constexpr int CELLS_PER_THREAD = 16;            // one 16-byte load of keep
constexpr int TILE = THREADS * CELLS_PER_THREAD;
constexpr unsigned FULL = 0xffffffffu;
// Flag status: aggregate, inclusive prefix, inclusive prefix with the
// tile's src/valid rows written.
constexpr unsigned long long ST_AGG = 1ull << 30, ST_PRE = 2ull << 30, ST_DONE = 3ull << 30;
constexpr unsigned long long VALUE = (1ull << 30) - 1;

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// Index of rank r in the shared list: one pad word per 32, so that lanes
// writing ranks 16 apart (a dense keep) hit distinct banks.
__device__ __forceinline__ int padded(int r) { return r + (r >> 5); }

// Keep bits of the 16 cells from c0 (bit b = cell c0 + b).
__device__ __forceinline__ unsigned keep_bits(const uint8_t* __restrict__ keep,
                                              long long n, long long c0, bool aligned) {
  unsigned bits = 0;
  if (aligned && c0 + CELLS_PER_THREAD <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(keep + c0);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      bits |= (unsigned)(((v.x >> (8 * b)) & 0xffu) != 0) << b;
      bits |= (unsigned)(((v.y >> (8 * b)) & 0xffu) != 0) << (4 + b);
      bits |= (unsigned)(((v.z >> (8 * b)) & 0xffu) != 0) << (8 + b);
      bits |= (unsigned)(((v.w >> (8 * b)) & 0xffu) != 0) << (12 + b);
    }
  } else {
    for (int b = 0; b < CELLS_PER_THREAD && c0 + b < n; ++b)
      bits |= (unsigned)(keep[c0 + b] != 0) << b;
  }
  return bits;
}

// Warp 0: the exclusive prefix of `tile` from its predecessors' flags, 128
// at a time (lane l reads predecessors 4l + 1 .. 4l + 4 back, four loads
// in flight), until the nearest inclusive prefix closes the sum.
__device__ __forceinline__ int look_back(const unsigned long long* flags, int tile,
                                         unsigned epoch, int lane) {
  int excl = 0;
  for (int look = tile - 1;; look -= 128) {
    for (;;) {
      unsigned long long f[4];
      unsigned st[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int idx = look - 4 * lane - k;
        f[k] = idx >= 0 ? ld_acquire(&flags[idx]) : ((unsigned long long)epoch << 32 | ST_PRE);
        st[k] = (unsigned)(f[k] >> 32) == epoch ? (unsigned)(f[k] >> 30) & 3u : 0u;
      }
      int pk = 4;                   // nearest inclusive prefix among this lane's four
#pragma unroll
      for (int k = 3; k >= 0; --k)
        if (st[k] >= 2) pk = k;
      bool bad = false;
      int sum = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k <= pk) {
          bad |= st[k] == 0;
          sum += (int)(f[k] & VALUE);
        }
      }
      const unsigned pre = __ballot_sync(FULL, pk < 4);
      const int fl = pre ? __ffs(pre) - 1 : 31;           // last lane that counts
      const unsigned upto = fl == 31 ? FULL : (2u << fl) - 1u;
      if (__ballot_sync(FULL, bad) & upto) continue;      // not all published yet
      int v = lane <= fl ? sum : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
      excl += v;
      if (pre) return excl;
      break;
    }
  }
}

// Warp 0: wait until the src rows below `a1` are written, i.e. every tile
// whose ranks start below a1 is done; returns min(total, a1) (the total
// once the last tile is done).  128 tiles at a time, four per lane.
__device__ __forceinline__ int covered(const unsigned long long* flags, int n_tiles, int a1,
                                       unsigned epoch, int lane) {
  int last = 0;                     // inclusive prefix of the last tile seen
  for (int w = 0; w < n_tiles; w += 128) {
    for (;;) {
      bool stop = false, wait = false;
      int incl = last;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = w + 4 * lane + k;
        if (t >= n_tiles || stop || wait) continue;
        const unsigned long long f = ld_acquire(&flags[t]);
        if ((f >> 30) != ((unsigned long long)epoch << 2 | 3u)) {
          wait = true;              // not done: needed unless an earlier tile reached a1
        } else {
          incl = (int)(f & VALUE);
          stop = incl >= a1;
        }
      }
      // the first lane that stops or waits decides: lanes before it are done
      const unsigned s_m = __ballot_sync(FULL, stop), w_m = __ballot_sync(FULL, wait);
      const unsigned first = (s_m | w_m) & (0u - (s_m | w_m));
      if (first & w_m & ~s_m) continue;   // a needed tile is not done yet
      if (first) return min(__shfl_sync(FULL, incl, __ffs(first) - 1), a1);
      last = __reduce_max_sync(FULL, incl);   // the prefixes grow with the tile
      break;
    }
  }
  return min(last, a1);
}

template <typename V>
__global__ void __launch_bounds__(THREADS) extract_kernel(
    const uint8_t* __restrict__ keep, long long n, int n_tiles, bool keep_aligned,
    const V* __restrict__ payload, int vpr, int cap, unsigned long long* __restrict__ flags,
    unsigned epoch, V* __restrict__ vals, int* __restrict__ src, uint8_t* __restrict__ valid,
    int* __restrict__ total) {
  extern __shared__ int s_cells[];   // [padded(TILE)]
  __shared__ int s_warp[WARPS];
  __shared__ int s_excl, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long tag = (unsigned long long)epoch << 32;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long c0 = (long long)tile * TILE + (long long)tid * CELLS_PER_THREAD;
    const unsigned bits = keep_bits(keep, n, c0, keep_aligned);
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, agg = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int v = s_warp[w];
      before += w < warp ? v : 0;
      agg += v;
    }
    if (tid == 0)
      st_release(&flags[tile], tag | (tile == 0 ? ST_PRE : ST_AGG) | (unsigned long long)agg);
    int r = before + incl - cnt;
    for (unsigned m = bits; m; m &= m - 1, ++r) s_cells[padded(r)] = (int)(c0 + __ffs(m) - 1);
    if (warp == 0) {
#if EXTRACT_ABLATE == 1
      const int excl = tile * agg;   // no look-back: wrong ranks, spread as the real ones
#else
      const int excl = tile == 0 ? 0 : look_back(flags, tile, epoch, lane);
#endif
      if (lane == 0) {
        s_excl = excl;
        if (tile > 0) st_release(&flags[tile], tag | ST_PRE | (unsigned long long)(excl + agg));
      }
    }
    __syncthreads();
    const int excl = s_excl;
    const int lim = min(agg, cap - excl);
    for (int j = tid; j < lim; j += THREADS) {
      src[excl + j] = s_cells[padded(j)];
      valid[excl + j] = 1;
    }
    __syncthreads();   // the rows, and s_cells, s_warp and s_excl of the next tile
    if (tid == 0) {
      // a release after the barrier: the CTA's row writes come before it
      st_release(&flags[tile], tag | ST_DONE | (unsigned long long)(excl + agg));
      if (tile == n_tiles - 1) *total = excl + agg;
    }
  }
  if (n_tiles == 0 && blockIdx.x == 0 && tid == 0) *total = 0;

  // The cap rows, split evenly over the CTAs: [a0, a1) is this CTA's share.
  const int per = (cap + gridDim.x - 1) / gridDim.x;
  const int a0 = min(blockIdx.x * per, cap), a1 = min(a0 + per, cap);
  if (warp == 0) {
    const int r = a1 > a0 ? covered(flags, n_tiles, a1, epoch, lane) : a1;
    if (lane == 0) s_total = r;
  }
  __syncthreads();
  const int rows = max(s_total, a0);   // [a0, rows) copied, [rows, a1) zeroed
#if EXTRACT_ABLATE != 3   // 3: no tail
  for (int j = rows + tid; j < a1; j += THREADS) {
    src[j] = 0;
    valid[j] = 0;
  }
  const V zero{};
  for (long long e = (long long)rows * vpr + tid; e < (long long)a1 * vpr; e += THREADS)
    vals[e] = zero;
#endif
#if EXTRACT_ABLATE != 2   // 2: no payload gather
  if (vpr > 0) {
    // `lpr` lanes per row, `rpw` rows per warp and pass, 4 passes in flight.
    const int lpr = vpr < 32 ? vpr : 32;
    const int rpw = 32 / lpr, sub = lane / lpr, c_lane = lane % lpr;
    const int step = WARPS * rpw, g1 = rows;
    for (int j = a0 + warp * rpw + sub; j < g1; j += 4 * step) {
      int from[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = j + u * step;
        from[u] = sub < rpw && jj < g1 ? __ldcg(&src[jj]) : -1;
#if EXTRACT_ABLATE == 1   // the spread ranks leave rows unwritten: keep reads in bounds
        if (from[u] >= n) from[u] = 0;
#endif
      }
      for (int c = c_lane; c < vpr; c += lpr) {
        V v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (from[u] >= 0) v[u] = payload[(long long)from[u] * vpr + c];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (from[u] >= 0) vals[(long long)(j + u * step) * vpr + c] = v[u];
      }
    }
  }
#endif
}

template <typename V>
int launch(const void* keep, const void* payload, long long n, int vpr, int cap,
           void* ws, unsigned epoch, void* vals, void* src, void* valid, void* total,
           cudaStream_t s) {
  static int resident[64];   // co-resident CTAs per SM, per device
  static int sms[64];
  const int smem = (TILE + TILE / 32) * (int)sizeof(int);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    e = cudaFuncSetAttribute(extract_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev], extract_kernel<V>,
                                                        THREADS, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int n_tiles = (int)((n + TILE - 1) / TILE);
  // Every co-resident CTA, also where the box has fewer tiles: the row
  // copy of a small box with a large cap (a refiner's s4) needs them all.
  const int grid = resident[dev] * sms[dev];
  bool aligned = ((uintptr_t)keep & 15) == 0;
  const uint8_t* k = (const uint8_t*)keep;
  const V* p = (const V*)payload;
  unsigned long long* flags = (unsigned long long*)ws;
  V* v = (V*)vals;
  int* sr = (int*)src;
  uint8_t* va = (uint8_t*)valid;
  int* t = (int*)total;
  void* args[] = {&k, &n, &n_tiles, &aligned, &p, &vpr, &cap, &flags, &epoch, &v, &sr, &va,
                  &t};
  e = cudaLaunchCooperativeKernel((const void*)extract_kernel<V>, dim3(grid), dim3(THREADS),
                                  args, (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ws: the workspace, ws_tiles 64-bit flag words zeroed when allocated;
// epoch: new for every call on it, never 0.
extern "C" int pasco_stream_extract(const void* keep, const void* payload, long long n,
                                    int E, int cap, void* ws, int ws_tiles, unsigned epoch,
                                    void* vals, void* src, void* valid, void* total,
                                    void* stream) {
  if (n < 0 || n >= (1ll << 30) || E < 0 || cap < 0 || epoch == 0 ||
      (n + TILE - 1) / TILE > ws_tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // Widest vector that divides a row (2E bytes) and both row arrays' base.
  const uintptr_t a = (uintptr_t)payload | (uintptr_t)vals;
  const int row = 2 * E;
  if (E == 0) return launch<unsigned short>(keep, nullptr, n, 0, cap, ws, epoch, nullptr,
                                            src, valid, total, s);
  if (row % 16 == 0 && a % 16 == 0)
    return launch<uint4>(keep, payload, n, row / 16, cap, ws, epoch, vals, src, valid, total, s);
  if (row % 8 == 0 && a % 8 == 0)
    return launch<uint2>(keep, payload, n, row / 8, cap, ws, epoch, vals, src, valid, total, s);
  if (row % 4 == 0 && a % 4 == 0)
    return launch<unsigned>(keep, payload, n, row / 4, cap, ws, epoch, vals, src, valid, total,
                            s);
  return launch<unsigned short>(keep, payload, n, E, cap, ws, epoch, vals, src, valid, total, s);
}
