// featurizer: per-cell max of sorted point features, occupancy and the
// enc_in 1x1 + bias, in one pass.
//
// Replaces the TPU kernel pasco_tpu/ops/pallas_featurizer.py:
// _featurizer_kernel (entry featurizer_fused, call _featurizer_call).
// Given the point features fs [P, F] sorted by their flat [X, Z, Y] cell
// key ks [P] (invalid points carry key n_cells and sort last) and head[i]
// set where a valid cell's run of points starts, it writes for every run
//   occ[key]     = 1
//   x[key, :]    = max_{i in run} fs[i, :] @ w + b     (f32 sums, rounded)
// and nothing else: the wrapper zero-fills x and occ (the empty cells).
// The max is order-independent, so the result is exact whatever order the
// sort leaves a run in.
//
// What bounds it on an H100: bytes, and few of them.  The TPU kernel
// walked the whole ~0.5 GB volume because its scatter was a per-row read-
// modify-write; here only the occupied cells are touched: each point row is
// read once (F * 2 bytes), each occupied cell's C outputs written once, and
// the empty cells cost one memset.  One warp per run: lanes hold the F
// features (coalesced row reads), the max stays in registers, and the 1x1
// broadcasts each feature by shuffle against W staged once per block in
// shared memory (lane-consecutive output channels: no bank conflicts).
// Blocks stride over the points so W is staged once per resident block.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_F = 128, MAX_C = 256;

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return pasco::bf(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = pasco::tobf(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) featurizer_kernel(
    const T* __restrict__ fs, const int* __restrict__ ks,
    const uint8_t* __restrict__ head, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ x, uint8_t* __restrict__ occ,
    int P, int F, int C) {
  extern __shared__ float ws[];        // [F][C], then b [C]
  float* bs = ws + F * C;
  for (int i = threadIdx.x; i < F * C; i += THREADS) ws[i] = w[i];
  for (int i = threadIdx.x; i < C; i += THREADS) bs[i] = b[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS;
  for (int i = warp; i < P; i += n_warps) {
    if (!head[i]) continue;            // warp-uniform
    const int key = ks[i];
    float m[MAX_F / 32];
#pragma unroll
    for (int j = 0; j < MAX_F / 32; ++j) {
      const int k = lane + 32 * j;
      m[j] = k < F ? load(fs, (long long)i * F + k) : 0.f;
    }
    for (int r = i + 1; r < P && ks[r] == key; ++r) {
#pragma unroll
      for (int j = 0; j < MAX_F / 32; ++j) {
        const int k = lane + 32 * j;
        if (k < F) m[j] = fmaxf(m[j], load(fs, (long long)r * F + k));
      }
    }
    float acc[MAX_C / 32];
#pragma unroll
    for (int q = 0; q < MAX_C / 32; ++q) {
      const int d = lane + 32 * q;
      acc[q] = d < C ? bs[d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < MAX_F / 32; ++j) {
      if (32 * j >= F) break;
      for (int l = 0; l < 32 && 32 * j + l < F; ++l) {
        const float mk = __shfl_sync(0xffffffffu, m[j], l);
        const float* wr = ws + (32 * j + l) * C;
#pragma unroll
        for (int q = 0; q < MAX_C / 32; ++q) {
          const int d = lane + 32 * q;
          if (d < C) acc[q] = fmaf(mk, wr[d], acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < MAX_C / 32; ++q) {
      const int d = lane + 32 * q;
      if (d < C) store(x, (long long)key * C + d, acc[q]);
    }
    if (lane == 0) occ[key] = 1;
  }
}

template <typename T>
int launch(const void* fs, const void* ks, const void* head, const void* w,
           const void* b, void* x, void* occ, int P, int F, int C,
           cudaStream_t s) {
  const size_t smem = (size_t)(F * C + C) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      featurizer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = (P + WARPS - 1) / WARPS;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  featurizer_kernel<T><<<blocks, THREADS, smem, s>>>(
      (const T*)fs, (const int*)ks, (const uint8_t*)head, (const float*)w,
      (const float*)b, (T*)x, (uint8_t*)occ, P, F, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32 features and output, 1 = bf16.
extern "C" int pasco_featurizer(const void* fs, const void* ks, const void* head,
                                const void* w, const void* b, void* x, void* occ,
                                int P, int F, int C, int dtype, void* stream) {
  if (F < 1 || F > MAX_F || C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(fs, ks, head, w, b, x, occ, P, F, C, s);
  if (dtype == 0) return launch<float>(fs, ks, head, w, b, x, occ, P, F, C, s);
  return (int)cudaErrorInvalidValue;
}
