// K1: C = A @ B and K2: C = act(A @ B + bias), for sm_90a.
//
// Replaces: src/repro/kernels/gemm.py::gemm (the Pallas TPU kernel
// `_matmul_kernel`, grid (M/bm, N/bn, K/bk) with k innermost) and
// src/repro/kernels/gemm.py::gemm_bias_act (the same grid; bias + act on
// the last k step while the output block is still in VMEM).
//
// What bounds it on an H100 (data-sheet peaks): in f32 the DeepBench shapes
// are bound by operations (67 TFLOP/s on the CUDA cores), except the skinny
// 35x700x2048 and 7680x1x2560, which are bound by bytes (3.35 TB/s).  In
// bf16, against the 989 TFLOP/s of the tensor cores, most are bound by
// bytes.
//
// Two main loops, chosen by a rule before the launch (kernels/gemm.py::
// gemm_route), never as a fallback:
//
// * wgmma (bf16 with K % 8 == 0 and 16-byte aligned operands): the tensor
//   cores.  B goes first through one transposing pass (transpose_kernel:
//   (K, N) -> (N, K)), so both operands are K-major with a 2K-byte row
//   stride, which TMA takes whatever N is.  One producer thread issues TMA
//   loads of 64-wide K panels (128-byte swizzle) into a ring of kWgStages
//   shared-memory stages guarded by full/empty mbarriers; one consumer
//   warpgroup per 64 rows of the tile runs wgmma.mma_async m64nBNk16 on
//   each stage as it lands, accumulating in registers, with one batch of
//   wgmma in flight while the next stage's batch is issued.
// * simt (f32, and bf16 that wgmma cannot take): IEEE f32 fmaf only, no
//   TF32, because the graph tier relies on exact sums of integers below
//   2^24.  8 x 4 register tiles per thread (128 to 512 threads; the narrow
//   tiles keep 256 threads with a (BM/16) x (BN/16) register tile); the A
//   and B panels are staged by cp.async (16, 8 or 4 bytes a copy, the
//   largest the rows' alignment allows; zero fill through the source size
//   at ragged edges) into kSimtStages stages, so the next panels load while
//   this one is used; the inner loop reads 4 k-steps of its A rows and its
//   B columns with vector loads (float4 for f32).  bf16 panels are widened
//   to f32 as they are read.
//
// Split-K: when a launch's output tiles are fewer than the card's SMs, the
// wrapper asks for S K-slices (gridDim.z; kernels/gemm.py::split_k).  Slice
// z covers BK-steps [z * steps / S, (z + 1) * steps / S) and writes raw f32
// partial sums into an S x M x N workspace; reduce_kernel then sums the S
// partials in slice order (no atomics: every run gives the same bits) and
// applies K2's epilogue.  Without split the epilogue runs on the register
// accumulators: the f32 bias, the activation (0 none, 1 sigmoid, 2 tanh,
// 3 relu; expf/tanhf, not the fast intrinsics, and no --use_fast_math) and
// one rounding to the input type, with masked stores at ragged edges.  One
// caller keeps the f32 sums of bf16 operands unrounded: K4's input
// projection (kernels/gemm.py::projection), whose G enters the gate sums
// in f32 as the JAX scan's x W does; the store then writes f32 (`c32`).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSimtStages = 3;
constexpr int kWgStages = 4;
constexpr int kWgBK = 64;  // one 128-byte swizzle row of bf16

// Status codes beside cudaError_t (kernels/cuda.py::check reads them).
constexpr int kNoSuchKernel = -1;
constexpr int kNoTensorMap = -2;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
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

// Where a main loop's sums go: the final store (bias may be null, act may
// be kNone: that is K1; with `c32`, in f32 to c32 instead of in T to c) or,
// with `partial`, slice z's f32 partial sums.
struct Epi {
  const float* bias;
  int act;
  float* partial;
  float* c32;
};

template <typename T>
__device__ __forceinline__ void store(const Epi& e, T* c, int m, int n,
                                      int row, int col, float v) {
  if (row >= m || col >= n) return;
  const size_t idx = static_cast<size_t>(row) * n + col;
  if (e.partial) {
    e.partial[static_cast<size_t>(blockIdx.z) * m * n + idx] = v;
    return;
  }
  if (e.bias) v += e.bias[col];
  v = activate(v, e.act);
  if (e.c32)
    e.c32[idx] = v;
  else
    c[idx] = from_f32<T>(v);
}

// This block's K range [kb, ke): slice blockIdx.z of gridDim.z over the
// ceil(k / bk) steps of depth bk.
__device__ __forceinline__ void k_slice(int k, int bk, int& kb, int& ke) {
  const long long steps = (k + bk - 1) / bk;
  kb = static_cast<int>(blockIdx.z * steps / gridDim.z) * bk;
  ke = min(k, static_cast<int>((blockIdx.z + 1) * steps / gridDim.z) * bk);
}

// ---- the transposing pass (wgmma route): Bt (N, K) = B (K, N)^T ----------

__global__ void __launch_bounds__(256)
    transpose_kernel(const bf16* __restrict__ b, bf16* __restrict__ bt, int k,
                     int n) {
  __shared__ bf16 tile[32][34];
  const int x = blockIdx.x * 32 + threadIdx.x;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int r = blockIdx.y * 32 + j;
    if (r < k && x < n) tile[j][threadIdx.x] = b[static_cast<size_t>(r) * n + x];
  }
  __syncthreads();
  const int xo = blockIdx.y * 32 + threadIdx.x;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int ro = blockIdx.x * 32 + j;
    if (ro < n && xo < k) bt[static_cast<size_t>(ro) * k + xo] = tile[threadIdx.x][j];
  }
}

// ---- split-K: sum the partials in slice order, then the epilogue ----------

template <typename T>
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ ws, int split,
                  const float* __restrict__ bias, int act, T* __restrict__ c,
                  int m, int n) {
  const size_t mn = static_cast<size_t>(m) * n;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < mn; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < split; ++s) v += ws[s * mn + i];
    if (bias) v += bias[i % n];
    c[i] = from_f32<T>(activate(v, act));
  }
}

// ---- the SIMT main loop ------------------------------------------------------

// V consecutive values at p (shared memory), widened to f32.
template <int V>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void lds(const bf16* p, float* o) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
  } else if constexpr (V == 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = __bfloat162float(*p);
  }
}

// Stage the R x C box at (r0, c0) of a row-major matrix with leading
// dimension ld into shared memory with row stride SS; rows >= rmax and
// columns >= cmax read as zeros.  Copies of BYTES each by cp.async.
template <typename T, int R, int C, int SS, int NT, int BYTES>
__device__ __forceinline__ void load_box_async(T* s, const T* g, int ld,
                                               int r0, int c0, int rmax,
                                               int cmax) {
  constexpr int E = BYTES / static_cast<int>(sizeof(T));
  constexpr int PER_ROW = C / E;
  for (int i = threadIdx.x; i < R * PER_ROW; i += NT) {
    const int r = i / PER_ROW, q = (i % PER_ROW) * E;
    const int gr = r0 + r, gq = c0 + q;
    const int valid = gr < rmax ? max(0, min(E, cmax - gq)) : 0;
    const T* src = valid > 0 ? g + static_cast<size_t>(gr) * ld + gq : g;
    hopper::cp_async<BYTES>(s + r * SS + q, src,
                            valid * static_cast<int>(sizeof(T)));
  }
}

// The same box, element by element through registers: for bf16 rows that
// are not 4-byte aligned (odd ld), which cp.async cannot copy.
template <typename T, int R, int C, int SS, int NT>
__device__ __forceinline__ void load_box_sync(T* s, const T* g, int ld, int r0,
                                              int c0, int rmax, int cmax) {
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, q = i % C;
    const int gr = r0 + r, gq = c0 + q;
    s[r * SS + q] = (gr < rmax && gq < cmax)
                        ? g[static_cast<size_t>(gr) * ld + gq]
                        : from_f32<T>(0.0f);
  }
}

// `vec`: bytes per copy, 16, 8 or 4, or 0 for the element-wise path; the
// same for every thread, so the branch does not diverge.
template <typename T, int R, int C, int SS, int NT>
__device__ __forceinline__ void load_box(T* s, const T* g, int ld, int r0,
                                         int c0, int rmax, int cmax, int vec) {
  switch (vec) {
    case 16: load_box_async<T, R, C, SS, NT, 16>(s, g, ld, r0, c0, rmax, cmax); break;
    case 8: load_box_async<T, R, C, SS, NT, 8>(s, g, ld, r0, c0, rmax, cmax); break;
    case 4: load_box_async<T, R, C, SS, NT, 4>(s, g, ld, r0, c0, rmax, cmax); break;
    default: load_box_sync<T, R, C, SS, NT>(s, g, ld, r0, c0, rmax, cmax);
  }
}

// The thread layout of a tile: an 8 x 4 register tile per thread where
// both tile dims are at least 64 (128 to 512 threads), else 16 x 16
// threads with a (BM/16) x (BN/16) register tile, so the narrow tiles keep
// 256 threads.  kernels/gemm.py::Route.threads follows the same rule.
template <typename T, int BM, int BN, int BK>
struct SimtTile {
  static constexpr bool kWide = BM >= 64 && BN >= 64;
  static constexpr int kTM = kWide ? 8 : BM / 16;  // rows of C per thread
  static constexpr int kTN = kWide ? 4 : BN / 16;  // columns of C per thread
  static constexpr int kNTX = BN / kTN;             // threads along N
  static constexpr int kThreads = kNTX * (BM / kTM);
  static constexpr int kV = kTN < 4 ? kTN : 4;  // columns per vector read
  // A panel row stride: one 16-byte pad keeps each row 16-byte aligned
  static constexpr int kSA = BK + 16 / static_cast<int>(sizeof(T));
  static constexpr int kAElems = BM * kSA;
  static constexpr int kBElems = BK * BN;
  static constexpr int kSmem =
      kSimtStages * (kAElems + kBElems) * static_cast<int>(sizeof(T));
};

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(SimtTile<T, BM, BN, BK>::kThreads)
    simt_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ c, Epi epi, int m, int n, int k, int va,
                int vb) {
  using G = SimtTile<T, BM, BN, BK>;
  constexpr int TM = G::kTM, TN = G::kTN, V = G::kV, SA = G::kSA;
  constexpr int NTX = G::kNTX, NT = G::kThreads;
  static_assert(BK % 4 == 0 && TN % V == 0, "tile");
  extern __shared__ __align__(16) unsigned char simt_smem[];
  T* sa = reinterpret_cast<T*>(simt_smem);
  T* sb = sa + kSimtStages * G::kAElems;

  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  int kb, ke;
  k_slice(k, BK, kb, ke);
  const int iters = (ke - kb + BK - 1) / BK;

  auto load = [&](int it) {
    const int st = it % kSimtStages, k0 = kb + it * BK;
    load_box<T, BM, BK, SA, NT>(sa + st * G::kAElems, a, k, row0, k0, m, ke, va);
    load_box<T, BK, BN, BN, NT>(sb + st * G::kBElems, b, n, k0, col0, ke, n, vb);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kSimtStages - 1; ++s) {
    if (s < iters) load(s);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    hopper::cp_async_wait<kSimtStages - 2>();  // stage `it` has landed
    __syncthreads();  // ... for every thread, and stage it - 1 is free
    if (it + kSimtStages - 1 < iters) load(it + kSimtStages - 1);
    hopper::cp_async_commit();
    const T* pa = sa + (it % kSimtStages) * G::kAElems + ty * TM * SA;
    const T* pb = sb + (it % kSimtStages) * G::kBElems + tx * V;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float av[TM][4], bv[4][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) lds<4>(pa + i * SA + kk, av[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int g = 0; g < TN / V; ++g)
          lds<V>(pb + (kk + q) * BN + g * NTX * V, &bv[q][g * V]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i][q], bv[q][j], acc[i][j]);
    }
  }

  // thread (tx, ty) owns rows ty*TM + i and columns g*NTX*V + tx*V + v
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      store<T>(epi, c, m, n, row0 + ty * TM + i,
               col0 + (j / V) * NTX * V + tx * V + j % V, acc[i][j]);
}

// ---- the wgmma main loop -----------------------------------------------------

template <int BM, int BN>
struct WgTile {
  static constexpr int kConsumers = BM / 64;  // warpgroups running wgmma
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer
  static constexpr int kABytes = BM * kWgBK * 2;
  static constexpr int kBBytes = BN * kWgBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // 1024 B of slack to align the ring to the swizzle's 1024-byte period,
  // the stages, then the full and empty barriers
  static constexpr int kSmem = 1024 + kWgStages * kStageBytes + 2 * kWgStages * 8;
};

template <int BM, int BN>
__global__ void __launch_bounds__(WgTile<BM, BN>::kThreads)
    wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, bf16* __restrict__ c,
                 Epi epi, int m, int n, int k) {
  using G = WgTile<BM, BN>;
  static_assert(BM % 64 == 0 && BN % 8 == 0 && G::kStageBytes % 1024 == 0,
                "tile");
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* ring =
      wg_smem + ((1024 - (hopper::smem_addr(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * G::kStageBytes);
  uint64_t* empty = full + kWgStages;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  int kb, ke;
  k_slice(k, kWgBK, kb, ke);
  const int iters = (ke - kb + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], G::kConsumers * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == G::kConsumers) {
    // producer: one thread keeps up to kWgStages panels in flight
    if (threadIdx.x == G::kConsumers * 128) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % kWgStages;
        hopper::mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], G::kStageBytes);
        unsigned char* stage = ring + s * G::kStageBytes;
        const int k0 = kb + it * kWgBK;
        hopper::tma_load_2d(stage, &ta, &full[s], k0, row0);
        hopper::tma_load_2d(stage + G::kABytes, &tb, &full[s], k0, col0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64*wg .. 64*wg + 63 of the tile
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const int s = it % kWgStages;
    hopper::mbar_wait(&full[s], (it / kWgStages) & 1);
    const unsigned char* stage = ring + s * G::kStageBytes;
    hopper::fence_regs(d);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      hopper::Wgmma<BN>::mma(
          d, hopper::wgmma_desc(stage + wg * 64 * 128 + kk * 32),
          hopper::wgmma_desc(stage + G::kABytes + kk * 32));
    }
    hopper::wgmma_commit();
    // keep this batch in flight; the one before has finished reading its
    // stage, which goes back to the producer
    hopper::wgmma_wait<1>();
    hopper::fence_regs(d);
    if (it > 0) hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);

  const int t = threadIdx.x % 128;
  const int r = row0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int cb = col0 + 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    store<bf16>(epi, c, m, n, r + 8 * ((i % 4) / 2), cb + 8 * (i / 4) + i % 2,
                d[i]);
}

// ---- host side -------------------------------------------------------------

// The operands of one main-loop launch, passed down the tile dispatch.
struct Args {
  const void* a;
  const void* b;  // B (K, N) for simt, Bt (N, K) for wgmma
  void* c;
  Epi epi;
  int m, n, k, split;
  cudaStream_t stream;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Bytes per cp.async copy for rows of `row_bytes` starting at p.
int vec_bytes(const void* p, long long row_bytes) {
  for (int v : {16, 8, 4})
    if (reinterpret_cast<uintptr_t>(p) % v == 0 && row_bytes % v == 0) return v;
  return 0;
}

// Raise the dynamic shared-memory limit of `kernel` once, before its first
// launch; without it a launch above 48 KB is refused.
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int BM, int BN, int BK>
int launch_simt(const Args& x) {
  using G = SimtTile<T, BM, BN, BK>;
  static const cudaError_t attr = allow_smem(simt_kernel<T, BM, BN, BK>, G::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(cdiv(x.n, BN), cdiv(x.m, BM), x.split);
  const int va = vec_bytes(x.a, static_cast<long long>(x.k) * sizeof(T));
  const int vb = vec_bytes(x.b, static_cast<long long>(x.n) * sizeof(T));
  simt_kernel<T, BM, BN, BK><<<grid, G::kThreads, G::kSmem, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b),
      static_cast<T*>(x.c), x.epi, x.m, x.n, x.k, va, vb);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, which has already
// loaded libcuda, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a K-major bf16 operand (rows, K): boxes of 64 x
// box_rows, 128-byte swizzle, zeros outside the tensor.
int k_major_map(CUtensorMap* map, const void* ptr, int rows, int k,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return kNoTensorMap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(bf16)};
  const cuuint32_t box[2] = {kWgBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kNoTensorMap;
}

template <int BM, int BN>
int launch_wgmma(const Args& x) {
  using G = WgTile<BM, BN>;
  static const cudaError_t attr = allow_smem(wgmma_kernel<BM, BN>, G::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap ta, tb;
  if (k_major_map(&ta, x.a, x.m, x.k, BM) || k_major_map(&tb, x.b, x.n, x.k, BN))
    return kNoTensorMap;
  const dim3 grid(cdiv(x.n, BN), cdiv(x.m, BM), x.split);
  wgmma_kernel<BM, BN><<<grid, G::kThreads, G::kSmem, x.stream>>>(
      ta, tb, static_cast<bf16*>(x.c), x.epi, x.m, x.n, x.k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM>
int simt_bn(int bn, int bk, const Args& x) {
  if (bk != 32) return kNoSuchKernel;
  switch (bn) {
    case 16: return launch_simt<T, BM, 16, 32>(x);
    case 32: return launch_simt<T, BM, 32, 32>(x);
    case 64: return launch_simt<T, BM, 64, 32>(x);
    case 128: return launch_simt<T, BM, 128, 32>(x);
    default: return kNoSuchKernel;
  }
}

template <typename T>
int simt(int bm, int bn, int bk, const Args& x) {
  switch (bm) {
    case 16: return simt_bn<T, 16>(bn, bk, x);
    case 32: return simt_bn<T, 32>(bn, bk, x);
    case 64: return simt_bn<T, 64>(bn, bk, x);
    case 128: return simt_bn<T, 128>(bn, bk, x);
    default: return kNoSuchKernel;
  }
}

template <int BM>
int wgmma_bn(int bn, const Args& x) {
  switch (bn) {
    case 16: return launch_wgmma<BM, 16>(x);
    case 32: return launch_wgmma<BM, 32>(x);
    case 64: return launch_wgmma<BM, 64>(x);
    case 128: return launch_wgmma<BM, 128>(x);
    case 256: return launch_wgmma<BM, 256>(x);
    default: return kNoSuchKernel;
  }
}

int wgmma(int bm, int bn, int bk, const Args& x) {
  if (bk != kWgBK) return kNoSuchKernel;
  switch (bm) {
    case 64: return wgmma_bn<64>(bn, x);
    case 128: return wgmma_bn<128>(bn, x);
    default: return kNoSuchKernel;
  }
}

}  // namespace

// Launches one call of K1 or K2 on `stream`: [the transposing pass of B],
// the main loop, [the split-K reduce].  Returns cudaGetLastError() after
// each launch (the first that is not 0), kNoSuchKernel (-1) for a dtype,
// route, tile or activation this library was not built for, or
// kNoTensorMap (-2) when cuTensorMapEncodeTiled refused a TMA descriptor.
//
// dtype: 0 float32, 1 bfloat16, of A and B; c_dtype: the same, of C, which
// is dtype or, for bf16 operands, float32 (the sums stored unrounded).
// route: 0 simt, 1 wgmma (bf16 only; bt is then N x K bf16 scratch for
// B^T).  split: K slices; > 1 needs ws, an S x M x N f32 scratch for the
// partial sums.  bias: N float32 values or null; act: 0 none, 1 sigmoid,
// 2 tanh, 3 relu.  C = act(A @ B + bias).
extern "C" int repro_gemm(int dtype, int c_dtype, int route, int bm, int bn,
                          int bk, int split, const void* a, const void* b,
                          void* bt, const void* bias, int act, void* c,
                          void* ws, int m, int n, int k, void* stream) {
  if (act < kNone || act > kRelu || split < 1 || (split > 1 && !ws) ||
      dtype < 0 || dtype > 1 || c_dtype < 0 || c_dtype > dtype ||
      route < 0 || route > 1 || (route == 1 && (dtype != 1 || !bt)))
    return kNoSuchKernel;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bias_f = static_cast<const float*>(bias);
  if (route == 1) {
    transpose_kernel<<<dim3(cdiv(n, 32), cdiv(k, 32)), dim3(32, 8), 0, s>>>(
        static_cast<const bf16*>(b), static_cast<bf16*>(bt), k, n);
    if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  float* c32 = dtype != c_dtype ? static_cast<float*>(c) : nullptr;
  const Epi epi = split > 1
                      ? Epi{nullptr, kNone, static_cast<float*>(ws), nullptr}
                      : Epi{bias_f, act, nullptr, c32};
  const Args x{a, route == 1 ? bt : b, c, epi, m, n, k, split, s};
  const int status = route == 1 ? wgmma(bm, bn, bk, x)
                     : dtype == 0 ? simt<float>(bm, bn, bk, x)
                                  : simt<bf16>(bm, bn, bk, x);
  if (status != 0 || split == 1) return status;
  const long long mn = static_cast<long long>(m) * n;
  const int blocks = static_cast<int>(mn < 132LL * 8 * 256 ? (mn + 255) / 256
                                                           : 132LL * 8);
  const auto* parts = static_cast<const float*>(ws);
  if (c_dtype == 0)
    reduce_kernel<float><<<blocks, 256, 0, s>>>(parts, split, bias_f, act,
                                                static_cast<float*>(c), m, n);
  else
    reduce_kernel<bf16><<<blocks, 256, 0, s>>>(parts, split, bias_f, act,
                                               static_cast<bf16*>(c), m, n);
  return static_cast<int>(cudaGetLastError());
}
