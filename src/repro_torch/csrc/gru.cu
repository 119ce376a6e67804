// K3, one fused GRU step h' = GRU(x, h), and K4, the GRU over a whole
// sequence, for sm_90a.
//
//   r  = sigmoid(x Wr + h Ur + br)
//   z  = sigmoid(x Wz + h Uz + bz)
//   n  = tanh(x Wn + r (h Un + bnh) + bnx)
//   h' = (1 - z) n + z h
//
// ---- K3: gru_step_kernel + gru_sum_kernel --------------------------------
//
// Replaces src/repro/kernels/gru.py::gru_cell (the Pallas TPU kernel
// `_gru_kernel`: one program per (bb, bh) tile, whole (E, bh) and (Hp, bh)
// weight panels resident in VMEM).
//
// What bounds it on an H100 (data-sheet peaks): bytes.  A step reads six
// weight matrices, 3 (E H + H H) f32 values: 77.1 MB at E = H = 1792, 23 us
// at 3.35 TB/s.  The batch is at most 32 rows, so each weight feeds at most
// 2 x 32 FLOPs, and 2 B (E + H) 3H FLOPs take about as long on the CUDA
// cores (67 TFLOP/s) as the bytes.
//
// What the design does about it: every weight is read from device memory
// once, by one block, and the card is filled.  The reduction runs over the
// E rows of [Wr|Wz|Wn] and then the H rows of [Ur|Uz|Un], in chunks of
// kStepKC rows.  A block owns a (BB, BH) tile of h' and one slice of those
// chunks (gridDim.y slices: kernels/gru.py::gru_split, so that the step's
// blocks fill whole waves of two resident blocks a SM).  It streams its weight
// panels and the matching columns of x or h through a kStepStages-deep
// cp.async ring, 16-byte copies where the route allows (VEC), and splits
// the chunk's rows over kStepThreads / units "k-lanes" inside the block:
// each thread keeps a 4-row x 4-column tile of the four sums (x Wr + h Ur,
// x Wz + h Uz, x Wn, h Un) in registers, 48 FMAs for three 16-byte and four
// 4-byte shared loads per row.  The k-lanes are summed through shared
// memory in lane order.  With one slice the block applies the bias and the
// gate epilogue itself; with more it writes its four partial sums, and
// gru_sum_kernel adds the slices in slice order (no atomics: the same bits
// every run) and applies the epilogue.
//
// ---- K4: gru_seq_kernel ---------------------------------------------------
//
// Replaces src/repro/kernels/gru.py::gru_seq (a lax.scan of K3).
//
// What bounds it on an H100: operations, 2 B 3H (E + H) FLOPs a step, and
// the T steps depend on each other.  The x W half has no such dependence;
// the h U half (0.62 GFLOP a step at B = 32, H = 1792: 9.2 us at 67
// TFLOP/s) is on the critical path, beside a per-step latency chain (an L2
// round trip for h, the epilogue, a grid barrier) of a few microseconds.
//
// x W does not depend on h, so the wrapper computes it for all T steps in
// one product before this kernel (K2, kernels/gru.py::gru_seq):
// G = xs [T B, E] @ [Wr|Wz|Wn] + [br|bz|bnx].  bnx folds into G because it
// sits outside r (..); bnh does not.  This kernel then runs all T steps of
// the recurrence in one cooperative launch, one block per SM at most: a
// block owns `cpb` hidden columns of all three gates and keeps the first
// `rows_res` rows of its U panel (Hp x 3 x cpb, packed by the wrapper)
// in shared memory for the whole sequence; the rest of the panel, where it
// does not fit, is read from device memory (L2) every step.  A step streams
// h, and the rows of U that are not resident, through a kSeqStages-deep
// cp.async ring of kSeqKC-row chunks in shared memory (each block reads all
// of h every step), and reduces h [Ur|Uz|Un] for the block's columns in
// f32 fmaf in a fixed order: a thread keeps kSeqRB batch rows x 1 column x
// 3 gates, and the chunk's rows are split over k-lanes of threads.  The
// k-lanes' sums meet in shared memory, where every thread of the block
// takes one element of h', adds its sums in lane order, adds the step's
// row of G (loaded at the start of the step, so its latency hides behind
// the reduction) and writes h' to one of two hidden-state buffers, used in
// turn; the last step writes `out`.  Block i starts its walk over the
// chunks at chunk i mod (Hp / kSeqKC), so the blocks do not all read the
// same lines of h at once.  A launch stages at most kSeqMaxB batch rows; a
// larger batch is run as groups of rows, one launch each (the rows of a GRU
// do not interact), each reading its rows of G with G's own row stride.
//
// One grid barrier per step is enough: step t reads only buffer (t-1)%2
// and writes only buffer t%2.  Step t+1 writes buffer (t+1)%2 = (t-1)%2,
// which every block finished reading before it arrived at the barrier
// after step t, and it reads buffer t%2, which every block finished
// writing before it arrived there.
//
// h written by other blocks in the same launch is read through L2
// (cp.async.cg, or __ldcg on the 4-byte route): L1 is not coherent across
// SMs, and a plain load could return a line cached two steps earlier.  The barrier is a counter that only grows:
// each block adds one per step and waits until it reaches
// (t + 1) x gridDim.x, with release/acquire fences around it.  A wait that
// outlasts 2^26 polls traps, so a fault ends the kernel with an error
// instead of hanging the card.  A grid that cannot be co-resident is
// refused before the launch (cudaErrorCooperativeLaunchTooLarge).
//
// ---- Operand types --------------------------------------------------------
//
// Both kernels take f32 or bf16 operands (T, one type for x, h and the ten
// parameters), as the Pallas kernel does: every load widens to f32, all
// arithmetic is f32, and h' is stored in T (`.astype(out_ref.dtype)`,
// src/repro/kernels/gru.py:51).  Shared memory stages T, so a bf16 ring or U
// panel row takes half the bytes of an f32 one.  K4's two hidden-state
// buffers hold T, so h is rounded to T after every step, as the JAX scan
// carries it; G, the projection of all steps, stays f32 whatever T is (the
// scan never rounds x W before the gate sums), and K3's split partials are
// f32.  K3's copies are 4 elements (16 bytes of f32, 8 of bf16) on the vec4
// route, else one element (a 2-byte bf16 is copied by a plain load, which
// cp.async cannot do); K4 stages h by 16-byte cp.async.cg (4 f32 or 8 bf16:
// the .ca form of the narrower copies would read L1) where H allows, else
// element by element through __ldcg.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNoSuchKernel = -1;
constexpr int kStepThreads = 256;
constexpr int kStepKC = 32;      // K3: reduction rows per chunk
constexpr int kStepStages = 3;   // K3: cp.async ring depth
constexpr int kSeqThreads = 512;
constexpr int kSeqKC = 64;       // K4: rows of h per staged chunk
constexpr int kSeqStages = 4;    // K4: cp.async ring depth
constexpr int kSeqMaxB = 64;     // K4: batch rows a block stages
constexpr int kRB = 4;           // K3: batch rows per thread
constexpr int kSeqRB = 8;        // K4: batch rows per thread

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive values at p (shared memory, 4-element aligned), widened.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One element of global memory through the read-only path (__ldg) or
// through L2 only (__ldcg: written by other blocks of the same launch).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ bf16 ldg(const bf16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ldcg(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// VW consecutive elements from src to dst (shared memory), zeros where !ok
// (src then unread): cp.async where that is 4 bytes or more, else a plain
// load and store.
template <typename T, int VW>
__device__ __forceinline__ void copy_group(T* dst, const T* src, bool ok) {
  constexpr int BYTES = VW * static_cast<int>(sizeof(T));
  if constexpr (BYTES >= 4)
    hopper::cp_async<BYTES>(dst, src, ok ? BYTES : 0);
  else
    *dst = ok ? *src : from_f32<T>(0.0f);
}

// The gate epilogue on the four f32 sums of one element.
__device__ __forceinline__ float gru_update(float ar, float az, float anx,
                                            float anh, float br, float bz,
                                            float bnx, float bnh, float hold) {
  const float r = sigmoid(ar + br);
  const float z = sigmoid(az + bz);
  const float n = tanhf(anx + r * (anh + bnh) + bnx);
  return (1.0f - z) * n + z * hold;
}

// ===========================================================================
// K3
// ===========================================================================

template <typename T>
struct StepArgs {
  const T* x;    // (B, E)
  const T* h;    // (B, H)
  const T* w[3];  // Wr, Wz, Wn: (E, H)
  const T* u[3];  // Ur, Uz, Un: (H, H)
  const T* br;
  const T* bz;
  const T* bnx;
  const T* bnh;
  T* out;       // (B, H), never h
  float* part;  // (4, split, B, H) partial sums when split > 1
  int B, E, H, split;
};

template <typename T, int BB, int BH>
struct StepTile {
  static constexpr int kRG = BB / kRB;              // thread rows
  static constexpr int kUnits = (BH / 4) * kRG;     // 4 x 4 tiles of h'
  static constexpr int kLanes = kStepThreads / kUnits;
  static constexpr int kVS = kStepKC + 4;           // x/h row stride
  static constexpr int kStage = 3 * kStepKC * BH + BB * kVS;  // elements
  // the ring, which the k-lanes' f32 sums reuse at the end (bytes)
  static constexpr int kRing = kStepStages * kStage * static_cast<int>(sizeof(T));
  static constexpr int kRed = (kLanes - 1) * kUnits * 16 * 4;
  static constexpr int kSmem = kRing > kRed ? kRing : kRed;
  static_assert(kStepThreads % kUnits == 0 && kStepKC % kLanes == 0, "tile");
};

// Copies chunk `ci` of the block's reduction into one ring stage: kStepKC
// rows of the three weight panels (columns j0..j0+BH) and of x or h (rows
// b0..b0+BB), zero-filled outside the operands.  VEC: 4-element copies (E
// and H multiples of 4, pointers 4-element aligned), else single elements.
template <typename T, int BB, int BH, bool VEC>
__device__ __forceinline__ void step_load(T* stage, const StepArgs<T>& p,
                                          int ci, int cx, int b0, int j0) {
  using G = StepTile<T, BB, BH>;
  constexpr int VW = VEC ? 4 : 1;
  const bool xphase = ci < cx;
  const int k0 = (xphase ? ci : ci - cx) * kStepKC;
  const int kdim = xphase ? p.E : p.H;
  const T* v = xphase ? p.x : p.h;
  constexpr int WPM = kStepKC * BH / VW;  // copies per weight matrix
  for (int i = threadIdx.x; i < 3 * WPM; i += kStepThreads) {
    const int g = i / WPM, r = (i % WPM) / (BH / VW);
    const int q = (i % (BH / VW)) * VW;
    const int gk = k0 + r, gj = j0 + q;
    const bool ok = gk < kdim && gj < p.H;
    // g is not a compile-time index: select, so p stays in parameter space
    const T* wg = xphase ? (g == 0 ? p.w[0] : g == 1 ? p.w[1] : p.w[2])
                         : (g == 0 ? p.u[0] : g == 1 ? p.u[1] : p.u[2]);
    const T* src = ok ? wg + static_cast<size_t>(gk) * p.H + gj : wg;
    copy_group<T, VW>(stage + (g * kStepKC + r) * BH + q, src, ok);
  }
  T* vs = stage + 3 * kStepKC * BH;
  constexpr int VPR = kStepKC / VW;  // copies per row of x or h
  for (int i = threadIdx.x; i < BB * VPR; i += kStepThreads) {
    const int b = i / VPR, q = (i % VPR) * VW;
    const int gb = b0 + b, gk = k0 + q;
    const bool ok = gb < p.B && gk < kdim;
    const T* src = ok ? v + static_cast<size_t>(gb) * kdim + gk : v;
    copy_group<T, VW>(vs + b * G::kVS + q, src, ok);
  }
}

__device__ __forceinline__ void fma4(float (&a)[4], float v, float4 w) {
  a[0] = fmaf(v, w.x, a[0]);
  a[1] = fmaf(v, w.y, a[1]);
  a[2] = fmaf(v, w.z, a[2]);
  a[3] = fmaf(v, w.w, a[3]);
}

// acc[0], acc[1], acc[NG] += v [W0 | W1 | W2] over this k-lane's rows of
// one staged chunk, for the thread's rows tb + kRG i and columns 4 tx ...
template <typename T, int BB, int BH, int NG>
__device__ __forceinline__ void step_fma(const T* stage, int lane, int tx,
                                         int tb,
                                         float (&acc)[4][kRB][4]) {
  using G = StepTile<T, BB, BH>;
  const T* ws = stage;
  const T* vs = stage + 3 * kStepKC * BH;
#pragma unroll 2
  for (int kk = lane; kk < kStepKC; kk += G::kLanes) {
    float4 wv[3];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      wv[g] = ld4(ws + (g * kStepKC + kk) * BH + 4 * tx);
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const float v = f32(vs[(tb + G::kRG * i) * G::kVS + kk]);
      fma4(acc[0][i], v, wv[0]);
      fma4(acc[1][i], v, wv[1]);
      fma4(acc[NG][i], v, wv[2]);
    }
  }
}

template <typename T, int BB, int BH, bool VEC>
__global__ void __launch_bounds__(kStepThreads)
    gru_step_kernel(StepArgs<T> p) {
  using G = StepTile<T, BB, BH>;
  extern __shared__ __align__(16) unsigned char step_bytes[];
  T* step_smem = reinterpret_cast<T*>(step_bytes);
  const int lane = threadIdx.x / G::kUnits;
  const int unit = threadIdx.x % G::kUnits;
  const int tx = unit % (BH / 4), tb = unit / (BH / 4);
  const int j0 = blockIdx.x * BH, b0 = blockIdx.z * BB;
  const int cx = cdiv(p.E, kStepKC);
  const int chunks = cx + cdiv(p.H, kStepKC);
  // this block's slice of the chunks: [cb, ce)
  const int cb = static_cast<int>(1LL * blockIdx.y * chunks / gridDim.y);
  const int ce = static_cast<int>(1LL * (blockIdx.y + 1) * chunks / gridDim.y);
  const int n = ce - cb;

  float acc[4][kRB][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < kRB; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[s][i][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStepStages - 1; ++s) {
    if (s < n)
      step_load<T, BB, BH, VEC>(step_smem + s * G::kStage, p, cb + s, cx, b0,
                                j0);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    hopper::cp_async_wait<kStepStages - 2>();  // chunk `it` has landed
    __syncthreads();  // ... for every thread, and stage it - 1 is free
    if (it + kStepStages - 1 < n)
      step_load<T, BB, BH, VEC>(
          step_smem + ((it + kStepStages - 1) % kStepStages) * G::kStage, p,
          cb + it + kStepStages - 1, cx, b0, j0);
    hopper::cp_async_commit();
    const T* stage = step_smem + (it % kStepStages) * G::kStage;
    if (cb + it < cx)
      step_fma<T, BB, BH, 2>(stage, lane, tx, tb, acc);
    else
      step_fma<T, BB, BH, 3>(stage, lane, tx, tb, acc);
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  // the k-lanes' sums, one set at a time, added in lane order
  float* red = reinterpret_cast<float*>(step_bytes);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (lane > 0)
#pragma unroll
      for (int i = 0; i < kRB; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[((lane - 1) * G::kUnits + unit) * 16 + 4 * i + c] = acc[s][i][c];
    __syncthreads();
    if (lane == 0)
      for (int l = 1; l < G::kLanes; ++l)
#pragma unroll
        for (int i = 0; i < kRB; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[s][i][c] += red[((l - 1) * G::kUnits + unit) * 16 + 4 * i + c];
    __syncthreads();
  }
  if (lane > 0) return;

  const size_t plane = static_cast<size_t>(p.B) * p.H;
#pragma unroll
  for (int i = 0; i < kRB; ++i) {
    const int b = b0 + tb + G::kRG * i;
    if (b >= p.B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 4 * tx + c;
      if (j >= p.H) continue;
      const size_t o = static_cast<size_t>(b) * p.H + j;
      if (gridDim.y == 1) {
        p.out[o] = from_f32<T>(gru_update(
            acc[0][i][c], acc[1][i][c], acc[2][i][c], acc[3][i][c],
            f32(p.br[j]), f32(p.bz[j]), f32(p.bnx[j]), f32(p.bnh[j]),
            f32(p.h[o])));
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          p.part[(static_cast<size_t>(s) * gridDim.y + blockIdx.y) * plane +
                 o] = acc[s][i][c];
      }
    }
  }
}

// Sums the split partial sums of each element in slice order, then the
// bias and the gate epilogue.
template <typename T>
__global__ void __launch_bounds__(256) gru_sum_kernel(StepArgs<T> p) {
  const size_t plane = static_cast<size_t>(p.B) * p.H;
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= plane) return;
  const int j = static_cast<int>(o % p.H);
  float a[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s] = 0.0f;
    for (int z = 0; z < p.split; ++z)
      a[s] += p.part[(static_cast<size_t>(s) * p.split + z) * plane + o];
  }
  p.out[o] = from_f32<T>(gru_update(a[0], a[1], a[2], a[3], f32(p.br[j]),
                                    f32(p.bz[j]), f32(p.bnx[j]),
                                    f32(p.bnh[j]), f32(p.h[o])));
}

template <typename T, int BB, int BH, bool VEC>
cudaError_t step_smem_attr() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gru_step_kernel<T, BB, BH, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, StepTile<T, BB, BH>::kSmem);
  return attr;
}

template <typename T, int BB, int BH, bool VEC>
int launch_step(const StepArgs<T>& p, cudaStream_t s) {
  using G = StepTile<T, BB, BH>;
  if (const cudaError_t e = step_smem_attr<T, BB, BH, VEC>())
    return static_cast<int>(e);
  const dim3 grid(cdiv(p.H, BH), p.split, cdiv(p.B, BB));
  gru_step_kernel<T, BB, BH, VEC><<<grid, kStepThreads, G::kSmem, s>>>(p);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (p.split == 1) return 0;
  const size_t plane = static_cast<size_t>(p.B) * p.H;
  gru_sum_kernel<T>
      <<<static_cast<unsigned>((plane + 255) / 256), 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a SM of the step kernel, at its dynamic shared memory.
template <typename T, int BB, int BH, bool VEC>
int step_occupancy(int* blocks) {
  if (const cudaError_t e = step_smem_attr<T, BB, BH, VEC>())
    return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gru_step_kernel<T, BB, BH, VEC>, kStepThreads,
      StepTile<T, BB, BH>::kSmem));
}

template <typename T_, int BB_, int BH_, bool VEC_>
struct StepKey {
  using T = T_;
  static constexpr int BB = BB_, BH = BH_;
  static constexpr bool VEC = VEC_;
};

// f(StepKey<T, BB, BH, VEC>{}) for a tile (bb, bh) and route this library
// was built for, else kNoSuchKernel.
template <typename T, bool VEC, typename F>
int with_tile(int bb, int bh, F&& f) {
  if (bb == 16 && bh == 16) return f(StepKey<T, 16, 16, VEC>{});
  if (bb == 16 && bh == 32) return f(StepKey<T, 16, 32, VEC>{});
  if (bb == 16 && bh == 64) return f(StepKey<T, 16, 64, VEC>{});
  if (bb == 32 && bh == 16) return f(StepKey<T, 32, 16, VEC>{});
  if (bb == 32 && bh == 32) return f(StepKey<T, 32, 32, VEC>{});
  if (bb == 32 && bh == 64) return f(StepKey<T, 32, 64, VEC>{});
  return kNoSuchKernel;
}

// dtype: 0 float32, 1 bfloat16 (kernels/gemm.py::DTYPES, as gemm.cu).
template <typename F>
int with_step(int dtype, int bb, int bh, int vec, F&& f) {
  if (dtype == 0)
    return vec ? with_tile<float, true>(bb, bh, f)
               : with_tile<float, false>(bb, bh, f);
  if (dtype == 1)
    return vec ? with_tile<bf16, true>(bb, bh, f)
               : with_tile<bf16, false>(bb, bh, f);
  return kNoSuchKernel;
}

// ===========================================================================
// K4
// ===========================================================================

// Elements of a staged row of h: kSeqKC columns plus a pad of 16 bytes,
// which keeps 16-byte copies aligned and staggers the rows over the banks.
template <typename T>
__host__ __device__ constexpr int seq_hs() {
  return kSeqKC + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
struct SeqArgs {
  const float* g;      // (T, gb, 3H): x [Wr|Wz|Wn] + [br|bz|bnx], from row 0
                       // of this launch's batch rows, in f32
  const T* h0;         // (B, H)
  const T* upack;      // (gridDim.x, Hp, 3, cpb): each block's U panel
  const T* bnh;        // (H)
  T* buf;              // (2, B, H): the hidden state, used in turn
  T* out;              // (B, H): the last step's h
  unsigned* bar;       // the grid barrier's counter, 0 at the launch
  int steps, B, gb, H, Hp, cpb, rows_res, lanes;  // gb: G's rows a step
};

// Arrive at the grid barrier of step t and wait for every block.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();  // the block's writes of h' are done ...
  if (threadIdx.x == 0) {
    __threadfence();  // ... and, cumulatively, visible device-wide
    atomicAdd(bar, 1u);
    unsigned seen = 0;
    for (uint32_t polls = 0;; ++polls) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(bar) : "memory");
      if (seen >= target) break;
      if (polls == (1u << 26)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// acc[i][g] += h[b_i, k] U_g[k, c] over rows [q0, q1) of one staged
// chunk: hs its h rows (stride seq_hs<T>()), u its U rows (3 cpb a row),
// both in shared memory.
template <typename T>
__device__ __forceinline__ void seq_fma(const T* __restrict__ hs,
                                        const T* __restrict__ u, int q0,
                                        int q1, int c, int tb, int rg, int cpb,
                                        float (&acc)[kSeqRB][3]) {
  const int row = 3 * cpb;
  for (int q = q0; q < q1; q += 4) {
    float4 hv[kSeqRB];
#pragma unroll
    for (int i = 0; i < kSeqRB; ++i)
      hv[i] = ld4(hs + (tb + rg * i) * seq_hs<T>() + q);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const T* ur = u + (q + s) * row + c;
      const float u0 = f32(ur[0]), u1 = f32(ur[cpb]), u2 = f32(ur[2 * cpb]);
#pragma unroll
      for (int i = 0; i < kSeqRB; ++i) {
        const float hk = s == 0 ? hv[i].x : s == 1 ? hv[i].y
                         : s == 2 ? hv[i].z : hv[i].w;
        acc[i][0] = fmaf(hk, u0, acc[i][0]);
        acc[i][1] = fmaf(hk, u1, acc[i][1]);
        acc[i][2] = fmaf(hk, u2, acc[i][2]);
      }
    }
  }
}

// Issues the copies of chunk k0 into one ring stage: the h rows (all bp
// batch rows, kSeqKC columns; rows >= B and columns >= H as zeros) and,
// where the panel's rows k0.. are not resident, those kSeqKC rows of the
// block's U panel.  VEC: h by 16-byte cp.async.cg, which reads L2 and
// never a stale L1 line; else by __ldcg, element by element, which waits
// for each load.  The U panel is read-only and 16-byte aligned: cp.async.
template <typename T, bool VEC>
__device__ __forceinline__ void seq_issue(T* stage, const T* hin,
                                          const T* panel, int k0,
                                          const SeqArgs<T>& p, int bp) {
  constexpr int V16 = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int VW = VEC ? V16 : 1;
  constexpr int PER_ROW = kSeqKC / VW;
  for (int i = threadIdx.x; i < bp * PER_ROW; i += kSeqThreads) {
    const int b = i / PER_ROW, q = (i % PER_ROW) * VW;
    const int gk = k0 + q;
    const bool ok = b < p.B && gk < p.H;
    T* dst = stage + b * seq_hs<T>() + q;
    const T* src = hin + static_cast<size_t>(b) * p.H + gk;
    if constexpr (VEC)
      hopper::cp_async<16>(dst, ok ? src : hin, ok ? 16 : 0);
    else
      *dst = ok ? ldcg(src) : from_f32<T>(0.0f);
  }
  if (k0 < p.rows_res) return;
  const int row = 3 * p.cpb;
  T* us = stage + bp * seq_hs<T>();
  const T* src = panel + static_cast<size_t>(k0) * row;
  for (int i = V16 * threadIdx.x; i < kSeqKC * row; i += V16 * kSeqThreads)
    hopper::cp_async<16>(us + i, src + i, 16);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kSeqThreads) gru_seq_kernel(SeqArgs<T> p) {
  extern __shared__ __align__(16) unsigned char seq_smem[];
  constexpr int HS = seq_hs<T>();
  const int rg = (p.B + kSeqRB - 1) / kSeqRB;  // thread rows
  const int bp = rg * kSeqRB;               // staged rows, padded with zeros
  const int units = p.cpb * rg;
  const int lane = threadIdx.x / units, unit = threadIdx.x % units;
  const int c = unit % p.cpb, tb = unit / p.cpb;
  const bool active = lane < p.lanes;
  const int kper = kSeqKC / p.lanes;
  const int row = 3 * p.cpb;
  const int c0 = blockIdx.x * p.cpb;

  // the resident rows of this block's U panel (rounded up to 16 bytes),
  // then the ring of staged chunks (which the k-lanes' f32 sums reuse at
  // the end of a step)
  const T* panel = p.upack + static_cast<size_t>(blockIdx.x) * p.Hp * row;
  T* us = reinterpret_cast<T*>(seq_smem);
  const int panel_bytes =
      (p.rows_res * row * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  T* ring = reinterpret_cast<T*>(seq_smem + panel_bytes);
  const int stage_elems = bp * HS + (p.rows_res < p.Hp ? kSeqKC * row : 0);
  float* red = reinterpret_cast<float*>(ring);
  for (int i = threadIdx.x; i < p.rows_res * row; i += kSeqThreads)
    us[i] = ldg(panel + i);
  __syncthreads();

  const size_t plane = static_cast<size_t>(p.B) * p.H;
  const int nchunks = p.Hp / kSeqKC;
  // Blocks walk the chunks from different starting points, so that at any
  // moment they read different lines of h: all 128 reading the same lines
  // at once queue at the L2 slices that hold them.
  const int first = blockIdx.x % nchunks;
  // The block's B x cpb elements of h' are shared out over all its threads
  // for the epilogue: element e = threadIdx.x + kSeqThreads m is (e / cpb,
  // e % cpb).  At the DeepBench sizes a thread has at most one.
  const int elems = p.B * p.cpb;
  const int eb = threadIdx.x / p.cpb, ej = c0 + threadIdx.x % p.cpb;
  const bool mine = threadIdx.x < elems && ej < p.H;
  for (int t = 0; t < p.steps; ++t) {
    const T* hin = t ? p.buf + ((t - 1) & 1) * plane : p.h0;
    T* hout = t == p.steps - 1 ? p.out : p.buf + (t & 1) * plane;
    float acc[kSeqRB][3];
#pragma unroll
    for (int i = 0; i < kSeqRB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;
    // the first element's operands, loaded now so that their latency
    // hides behind the reduction: the step's row of G, and h (taken from
    // the staged chunk that holds the element's column)
    float gv[3], hold = 0.0f;
    {
      const float* grow = p.g + (static_cast<size_t>(t) * p.gb + eb) * 3 * p.H;
#pragma unroll
      for (int g = 0; g < 3; ++g) gv[g] = mine ? __ldg(grow + g * p.H + ej) : 0.f;
    }

#pragma unroll
    for (int s = 0; s < kSeqStages - 1; ++s) {
      if (s < nchunks)
        seq_issue<T, VEC>(ring + s * stage_elems, hin, panel,
                          (first + s) % nchunks * kSeqKC, p, bp);
      hopper::cp_async_commit();
    }
    for (int ci = 0; ci < nchunks; ++ci) {
      hopper::cp_async_wait<kSeqStages - 2>();  // chunk ci has landed
      __syncthreads();  // ... for every thread, and stage ci - 1 is free
      const int next = ci + kSeqStages - 1;
      if (next < nchunks)
        seq_issue<T, VEC>(ring + (next % kSeqStages) * stage_elems, hin,
                          panel, (first + next) % nchunks * kSeqKC, p, bp);
      hopper::cp_async_commit();
      const int k0 = (first + ci) % nchunks * kSeqKC;
      const T* stage = ring + (ci % kSeqStages) * stage_elems;
      const T* u = k0 < p.rows_res ? us + k0 * row : stage + bp * HS;
      if (active)
        seq_fma<T>(stage, u, lane * kper, (lane + 1) * kper, c, tb, rg, p.cpb,
                   acc);
      if (mine && ej >= k0 && ej < k0 + kSeqKC)
        hold = f32(stage[eb * HS + ej - k0]);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();

    // every k-lane's sums to shared memory; each element then adds its
    // column's sums in lane order and runs the gate epilogue
    if (active)
#pragma unroll
      for (int i = 0; i < kSeqRB; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          red[(lane * units + unit) * (3 * kSeqRB) + 3 * i + g] = acc[i][g];
    __syncthreads();
    for (int e = threadIdx.x; e < elems; e += kSeqThreads) {
      const int b = e / p.cpb, ec = e % p.cpb, j = c0 + ec;
      if (j >= p.H) continue;
      const bool first_elem = e == threadIdx.x;
      const float* grow = p.g + (static_cast<size_t>(t) * p.gb + b) * 3 * p.H;
      // b is row i = b / rg of unit (b % rg, ec)
      const float* r0 = red + ((b % rg) * p.cpb + ec) * (3 * kSeqRB) +
                        3 * (b / rg);
      float sr = 0.0f, sz = 0.0f, sn = 0.0f;
      for (int l = 0; l < p.lanes; ++l) {
        const float* rl = r0 + l * units * (3 * kSeqRB);
        sr += rl[0];
        sz += rl[1];
        sn += rl[2];
      }
      const size_t o = static_cast<size_t>(b) * p.H + j;
      const float r = sigmoid((first_elem ? gv[0] : __ldg(grow + j)) + sr);
      const float z = sigmoid((first_elem ? gv[1] : __ldg(grow + p.H + j)) + sz);
      const float n = tanhf((first_elem ? gv[2] : __ldg(grow + 2 * p.H + j)) +
                            r * (sn + f32(ldg(p.bnh + j))));
      const float h = first_elem ? hold : f32(ldcg(hin + o));
      hout[o] = from_f32<T>((1.0f - z) * n + z * h);
    }
    // the k-lane sums and the next step's first stages share memory: the
    // barrier's __syncthreads comes between them
    if (t + 1 < p.steps) grid_barrier(p.bar, (t + 1u) * gridDim.x);
  }
}

}  // namespace

// One K3 step: [gru_step_kernel, then gru_sum_kernel when split > 1] on
// `stream`.  dtype: 0 float32, 1 bfloat16, of x, h, the ten parameters and
// out; all contiguous, on one device; out is not h; part holds 4 x split x
// B x H floats when split > 1.  vec: 4-element copies (E % 4 == H % 4 ==
// 0, x, h, W*, U* 4-element aligned).  Returns cudaGetLastError() after
// each launch (the first that is not 0), or -1 for a dtype or tile this
// library was not built for.
extern "C" int repro_gru_cell(int dtype, int bb, int bh, int vec, int split,
                              const void* x, const void* h, const void* wr,
                              const void* ur, const void* wz, const void* uz,
                              const void* wn, const void* un, const void* br,
                              const void* bz, const void* bnx, const void* bnh,
                              void* out, void* part, int B, int E, int H,
                              void* stream) {
  if (split < 1 || (split > 1 && !part)) return kNoSuchKernel;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_step(dtype, bb, bh, vec, [&](auto k) {
    using K = decltype(k);
    using T = typename K::T;
    const auto f = [](const void* q) { return static_cast<const T*>(q); };
    const StepArgs<T> p{f(x),   f(h),   {f(wr), f(wz), f(wn)},
                        {f(ur), f(uz), f(un)}, f(br), f(bz), f(bnx), f(bnh),
                        static_cast<T*>(out), static_cast<float*>(part), B, E,
                        H, split};
    return launch_step<T, K::BB, K::BH, K::VEC>(p, s);
  });
}

// Resident blocks a SM of K3's step kernel for `dtype` at tile (bb, bh) and
// route vec into *blocks (one int), as the occupancy calculator gives them
// for the registers this build took: kernels/gru.py::gru_split's cost
// model waves the step's grid over these.  Returns 0, -1 for a dtype or
// tile this library was not built for, else the CUDA error.
extern "C" int repro_gru_cell_occupancy(int dtype, int bb, int bh, int vec,
                                        void* blocks) {
  return with_step(dtype, bb, bh, vec, [&](auto k) {
    using K = decltype(k);
    return step_occupancy<typename K::T, K::BB, K::BH, K::VEC>(
        static_cast<int*>(blocks));
  });
}

// The constants that kernels/gru.py mirrors for its launch plans, as
// six ints into out: kStepKC, kSeqThreads, kSeqKC, kSeqStages, kSeqRB,
// kSeqMaxB.  The wrapper compares them with its copies when it binds this
// library and raises on a difference.  Returns 0.
extern "C" int repro_gru_constants(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = kStepKC;
  o[1] = kSeqThreads;
  o[2] = kSeqKC;
  o[3] = kSeqStages;
  o[4] = kSeqRB;
  o[5] = kSeqMaxB;
  return 0;
}

// The dynamic shared memory gru_seq_kernel lays out for operands of `esize`
// bytes: the resident rows of the U panel (rounded up to 16 bytes), then
// the ring of kSeqStages chunks, which the k-lanes' f32 sums reuse.
static long long seq_smem_bytes(int B, int cpb, int rows_res, int lanes,
                                int Hp, int esize) {
  const long long rg = cdiv(B, kSeqRB), row = 3LL * cpb;
  const long long stage = rg * kSeqRB * (kSeqKC + 16 / esize) +
                          (rows_res < Hp ? kSeqKC * row : 0);
  const long long ring = kSeqStages * stage * esize;
  const long long red = 4LL * lanes * cpb * rg * 3 * kSeqRB;
  return (rows_res * row * esize + 15) / 16 * 16 + (ring > red ? ring : red);
}

template <typename T>
int launch_seq(int vec, int blocks, int smem, const SeqArgs<T>& p,
               cudaStream_t s) {
  void (*kernel)(SeqArgs<T>) =
      vec ? gru_seq_kernel<T, true> : gru_seq_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kSeqThreads, smem)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (blocks > per_sm * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if ((e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), s)) != cudaSuccess)
    return static_cast<int>(e);
  SeqArgs<T> args_p = p;
  void* args[] = {&args_p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(blocks), dim3(kSeqThreads), args, smem,
                                  s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K4's recurrence over B <= kSeqMaxB batch rows: one cooperative launch of
// `blocks` blocks running all T steps (kernels/gru.py::gru_seq_launch sets
// blocks, cpb, rows_res, lanes and smem; the wrapper launches once for each
// group of at most kSeqMaxB rows).  dtype: 0 float32, 1 bfloat16, of h0,
// upack, bnh, buf and out.  g: the group's first row of G, a (T, gb, 3H)
// f32 array; h0, out: (B, H); upack: (blocks, Hp, 3, cpb); buf: 2 B H
// scratch; bar: one 32-bit counter of scratch, zeroed here.  vec: 16-byte
// loads of h (H a multiple of 4 f32 or 8 bf16, h0 16-byte aligned).
// Returns cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident, -1 for arguments the kernel does not take (smem smaller
// than its layout among them), else cudaGetLastError() after the launch.
extern "C" int repro_gru_seq(int dtype, int vec, int blocks, int cpb,
                             int rows_res, int lanes, int smem, const void* g,
                             const void* h0, const void* upack,
                             const void* bnh, void* buf, void* out, void* bar,
                             int T, int B, int gb, int H, int Hp,
                             void* stream) {
  const int rg = (B + kSeqRB - 1) / kSeqRB;
  const int esize = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 1 || B < 1 || B > kSeqMaxB || gb < B || T < 1 ||
      H < 1 || cpb < 1 || blocks < 1 || 1LL * blocks * cpb < H ||
      lanes < 1 || cpb * rg * lanes > kSeqThreads ||
      kSeqKC % (4 * lanes) != 0 || Hp % kSeqKC != 0 || Hp < H ||
      rows_res < 0 || rows_res > Hp ||
      (rows_res != Hp && rows_res % kSeqKC != 0) ||
      smem < seq_smem_bytes(B, cpb, rows_res, lanes, Hp, esize))
    return kNoSuchKernel;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  auto* counter = static_cast<unsigned*>(bar);
  if (dtype == 0)
    return launch_seq<float>(
        vec, blocks, smem,
        SeqArgs<float>{gf, static_cast<const float*>(h0),
                       static_cast<const float*>(upack),
                       static_cast<const float*>(bnh), static_cast<float*>(buf),
                       static_cast<float*>(out), counter, T, B, gb, H, Hp, cpb,
                       rows_res, lanes},
        s);
  return launch_seq<bf16>(
      vec, blocks, smem,
      SeqArgs<bf16>{gf, static_cast<const bf16*>(h0),
                    static_cast<const bf16*>(upack),
                    static_cast<const bf16*>(bnh), static_cast<bf16*>(buf),
                    static_cast<bf16*>(out), counter, T, B, gb, H, Hp, cpb,
                    rows_res, lanes},
      s);
}
