// K1: C = A @ B, a shared-memory-tiled SIMT GEMM for sm_90a, and
// K2: C = act(A @ B + bias), the same main loop with an epilogue.
//
// Replaces: src/repro/kernels/gemm.py::gemm (the Pallas TPU kernel
// `_matmul_kernel`, grid (M/bm, N/bn, K/bk) with k innermost) and
// src/repro/kernels/gemm.py::gemm_bias_act (the same grid; bias + act on
// the last k step while the output block is still in VMEM).
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
//
// K2's epilogue is a template flag (EPI), so K1's instantiations compile to
// the code they had and the epilogue only doubles the instantiation count.
// With EPI the f32 bias (one value per column, loaded once per thread) is
// added to the f32 register accumulators and the activation applied there,
// before the single rounding to the input type: the Pallas kernel's last-k
// epilogue without a trip through memory.  The activation is a runtime,
// warp-uniform argument (0 none, 1 sigmoid, 2 tanh, 3 relu).  expf and tanhf
// are the accurate library functions, not the fast intrinsics, and the file
// is built without --use_fast_math: the f32 parity tolerance is 1e-5.
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

enum Act { kNone = 0, kSigmoid = 1, kTanh = 2, kRelu = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kSigmoid: return 1.0f / (1.0f + expf(-v));
    case kTanh: return tanhf(v);
    case kRelu: return fmaxf(v, 0.0f);
    default: return v;
  }
}

template <typename T, int BM, int BN, int BK, bool EPI>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ bias, T* __restrict__ c, int m,
                int n, int k, int act) {
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

  float bias_v[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gq = col0 + tx + 16 * j;
    bias_v[j] = (EPI && gq < n) ? bias[gq] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gq = col0 + tx + 16 * j;
      if (gq >= n) continue;
      float v = acc[i][j];
      if constexpr (EPI) v = activate(v + bias_v[j], act);
      c[(size_t)gr * n + gq] = from_f32<T>(v);
    }
  }
}

// The operands of one launch, passed down the tile dispatch unchanged.
struct Args {
  const void* a;
  const void* b;
  const float* bias;
  void* c;
  int m, n, k, act;
  cudaStream_t stream;
};

template <typename T, bool EPI, int BM, int BN, int BK>
int launch(const Args& x) {
  const dim3 grid((x.n + BN - 1) / BN, (x.m + BM - 1) / BM);
  gemm_kernel<T, BM, BN, BK, EPI><<<grid, kThreads, 0, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), x.bias,
      static_cast<T*>(x.c), x.m, x.n, x.k, x.act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool EPI, int BM, int BN>
int dispatch_bk(int bk, const Args& x) {
  switch (bk) {
    case 16: return launch<T, EPI, BM, BN, 16>(x);
    case 32: return launch<T, EPI, BM, BN, 32>(x);
    default: return -1;
  }
}

template <typename T, bool EPI, int BM>
int dispatch_bn(int bn, int bk, const Args& x) {
  switch (bn) {
    case 16: return dispatch_bk<T, EPI, BM, 16>(bk, x);
    case 32: return dispatch_bk<T, EPI, BM, 32>(bk, x);
    case 64: return dispatch_bk<T, EPI, BM, 64>(bk, x);
    case 128: return dispatch_bk<T, EPI, BM, 128>(bk, x);
    default: return -1;
  }
}

template <typename T, bool EPI>
int dispatch_bm(int bm, int bn, int bk, const Args& x) {
  switch (bm) {
    case 16: return dispatch_bn<T, EPI, 16>(bn, bk, x);
    case 32: return dispatch_bn<T, EPI, 32>(bn, bk, x);
    case 64: return dispatch_bn<T, EPI, 64>(bn, bk, x);
    case 128: return dispatch_bn<T, EPI, 128>(bn, bk, x);
    default: return -1;
  }
}

template <bool EPI>
int dispatch(int dtype, int bm, int bn, int bk, const Args& x) {
  switch (dtype) {
    case 0: return dispatch_bm<float, EPI>(bm, bn, bk, x);
    case 1: return dispatch_bm<__nv_bfloat16, EPI>(bm, bn, bk, x);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Both entries return cudaGetLastError()
// after the launch, or -1 for a dtype, tile or activation this library was
// not built for.
extern "C" int repro_gemm(int dtype, int bm, int bn, int bk, const void* a,
                          const void* b, void* c, int m, int n, int k,
                          void* stream) {
  const Args x{a, b, nullptr, c, m, n, k, kNone,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, bm, bn, bk, x);
}

// act: 0 none, 1 sigmoid, 2 tanh, 3 relu.  bias: N float32 values.
extern "C" int repro_gemm_bias_act(int dtype, int bm, int bn, int bk, int act,
                                   const void* a, const void* b,
                                   const void* bias, void* c, int m, int n,
                                   int k, void* stream) {
  if (act < kNone || act > kRelu) return -1;
  const Args x{a, b, static_cast<const float*>(bias), c, m, n, k, act,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, bm, bn, bk, x);
}
