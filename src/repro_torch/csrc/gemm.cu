// K1: C = A @ B, a shared-memory-tiled SIMT GEMM for sm_90a.
//
// Replaces: src/repro/kernels/gemm.py::gemm (the Pallas TPU kernel
// `_matmul_kernel`, grid (M/bm, N/bn, K/bk) with k innermost).
//
// What bounds it on an H100 (data-sheet peaks): in f32 the DeepBench shapes
// are bound by operations (67 TFLOP/s on the CUDA cores), except the skinny
// 35x700x2048 and 7680x1x2560, which are bound by bytes (3.35 TB/s).  In
// bf16 against the 989 TFLOP/s tensor-core peak, which this SIMT kernel does
// not reach, most shapes are bound by bytes.  The f32 path stays IEEE f32
// FMA (no TF32): the parity tests hold it to 1e-5.
//
// What the design does about it: each block of 256 threads owns a
// (BM, BN) tile of C and walks K in BK-deep panels staged in shared memory,
// so every A element read from device memory feeds BN FMAs and every B
// element BM; each thread keeps a (BM/16) x (BN/16) register tile of f32
// accumulators.  The Pallas kernel's sequential k grid axis becomes this k
// loop inside the block, because blocks run in parallel and in no order.
// Ragged M/N/K edges are masked on load (zero fill) and on store, so no
// padded copies are made.  The panels are stored in the input
// type and widened to f32 when read; the output is rounded to the input
// type once.  Tensor cores (wgmma), TMA and a multi-stage pipeline are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ T zero() {
  return from_f32<T>(0.0f);
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ c, int m, int n, int k) {
  constexpr int TM = BM / 16;  // rows of C per thread
  constexpr int TN = BN / 16;  // columns of C per thread
  // Every tile holds at least kThreads elements (16 x 16), so the load
  // loops below have whole trip counts.
  // A panel row padding: a row is an odd number of 32-bit words, so the two
  // rows a warp reads at once fall in different banks.
  constexpr int PAD = 4 / sizeof(T);
  __shared__ T a_tile[BM][BK + PAD];
  __shared__ T b_tile[BK][BN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / kThreads; ++s) {
      const int idx = threadIdx.x + s * kThreads;
      const int r = idx / BK, q = idx % BK;
      const int gr = row0 + r, gq = k0 + q;
      a_tile[r][q] = (gr < m && gq < k) ? a[(size_t)gr * k + gq] : zero<T>();
    }
#pragma unroll
    for (int s = 0; s < BK * BN / kThreads; ++s) {
      const int idx = threadIdx.x + s * kThreads;
      const int r = idx / BN, q = idx % BN;
      const int gr = k0 + r, gq = col0 + q;
      b_tile[r][q] = (gr < k && gq < n) ? b[(size_t)gr * n + gq] : zero<T>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = to_f32(a_tile[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = to_f32(b_tile[kk][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gq = col0 + tx + 16 * j;
      if (gq < n) c[(size_t)gr * n + gq] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<T, BM, BN, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int BN>
int dispatch_bk(int bk, const void* a, const void* b, void* c, int m, int n,
                int k, cudaStream_t s) {
  switch (bk) {
    case 16: return launch<T, BM, BN, 16>(a, b, c, m, n, k, s);
    case 32: return launch<T, BM, BN, 32>(a, b, c, m, n, k, s);
    default: return -1;
  }
}

template <typename T, int BM>
int dispatch_bn(int bn, int bk, const void* a, const void* b, void* c, int m,
                int n, int k, cudaStream_t s) {
  switch (bn) {
    case 16: return dispatch_bk<T, BM, 16>(bk, a, b, c, m, n, k, s);
    case 32: return dispatch_bk<T, BM, 32>(bk, a, b, c, m, n, k, s);
    case 64: return dispatch_bk<T, BM, 64>(bk, a, b, c, m, n, k, s);
    case 128: return dispatch_bk<T, BM, 128>(bk, a, b, c, m, n, k, s);
    default: return -1;
  }
}

template <typename T>
int dispatch_bm(int bm, int bn, int bk, const void* a, const void* b, void* c,
                int m, int n, int k, cudaStream_t s) {
  switch (bm) {
    case 16: return dispatch_bn<T, 16>(bn, bk, a, b, c, m, n, k, s);
    case 32: return dispatch_bn<T, 32>(bn, bk, a, b, c, m, n, k, s);
    case 64: return dispatch_bn<T, 64>(bn, bk, a, b, c, m, n, k, s);
    case 128: return dispatch_bn<T, 128>(bn, bk, a, b, c, m, n, k, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or -1 for a dtype or tile this library was not built for.
extern "C" int repro_gemm(int dtype, int bm, int bn, int bk, const void* a,
                          const void* b, void* c, int m, int n, int k,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_bm<float>(bm, bn, bk, a, b, c, m, n, k, s);
    case 1:
      return dispatch_bm<__nv_bfloat16>(bm, bn, bk, a, b, c, m, n, k, s);
    default: return -1;
  }
}
