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
// `rows_res` rows of its U panel (Hp x 3 x cpb f32, packed by the wrapper)
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
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

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

struct StepArgs {
  const float* x;    // (B, E)
  const float* h;    // (B, H)
  const float* w[3];  // Wr, Wz, Wn: (E, H)
  const float* u[3];  // Ur, Uz, Un: (H, H)
  const float* br;
  const float* bz;
  const float* bnx;
  const float* bnh;
  float* out;   // (B, H), never h
  float* part;  // (4, split, B, H) partial sums when split > 1
  int B, E, H, split;
};

template <int BB, int BH>
struct StepTile {
  static constexpr int kRG = BB / kRB;              // thread rows
  static constexpr int kUnits = (BH / 4) * kRG;     // 4 x 4 tiles of h'
  static constexpr int kLanes = kStepThreads / kUnits;
  static constexpr int kVS = kStepKC + 4;           // x/h row stride
  static constexpr int kStage = 3 * kStepKC * BH + BB * kVS;  // floats
  static constexpr int kSmem = kStepStages * kStage * 4;      // bytes
  static_assert(kStepThreads % kUnits == 0 && kStepKC % kLanes == 0, "tile");
  static_assert((kLanes - 1) * kUnits * 16 <= kStepStages * kStage, "red");
};

// Copies chunk `ci` of the block's reduction into one ring stage: kStepKC
// rows of the three weight panels (columns j0..j0+BH) and of x or h (rows
// b0..b0+BB), zero-filled outside the operands.  VEC: 16-byte copies (E and
// H multiples of 4, pointers 16-byte aligned), else 4-byte ones.
template <int BB, int BH, bool VEC>
__device__ __forceinline__ void step_load(float* stage, const StepArgs& p,
                                          int ci, int cx, int b0, int j0) {
  using G = StepTile<BB, BH>;
  constexpr int VW = VEC ? 4 : 1;
  const bool xphase = ci < cx;
  const int k0 = (xphase ? ci : ci - cx) * kStepKC;
  const int kdim = xphase ? p.E : p.H;
  const float* v = xphase ? p.x : p.h;
  constexpr int WPM = kStepKC * BH / VW;  // copies per weight matrix
  for (int i = threadIdx.x; i < 3 * WPM; i += kStepThreads) {
    const int g = i / WPM, r = (i % WPM) / (BH / VW);
    const int q = (i % (BH / VW)) * VW;
    const int gk = k0 + r, gj = j0 + q;
    const bool ok = gk < kdim && gj < p.H;
    // g is not a compile-time index: select, so p stays in parameter space
    const float* wg = xphase ? (g == 0 ? p.w[0] : g == 1 ? p.w[1] : p.w[2])
                             : (g == 0 ? p.u[0] : g == 1 ? p.u[1] : p.u[2]);
    const float* src = ok ? wg + static_cast<size_t>(gk) * p.H + gj : wg;
    hopper::cp_async<4 * VW>(stage + (g * kStepKC + r) * BH + q, src,
                             ok ? 4 * VW : 0);
  }
  float* vs = stage + 3 * kStepKC * BH;
  constexpr int VPR = kStepKC / VW;  // copies per row of x or h
  for (int i = threadIdx.x; i < BB * VPR; i += kStepThreads) {
    const int b = i / VPR, q = (i % VPR) * VW;
    const int gb = b0 + b, gk = k0 + q;
    const bool ok = gb < p.B && gk < kdim;
    const float* src = ok ? v + static_cast<size_t>(gb) * kdim + gk : v;
    hopper::cp_async<4 * VW>(vs + b * G::kVS + q, src, ok ? 4 * VW : 0);
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
template <int BB, int BH, int NG>
__device__ __forceinline__ void step_fma(const float* stage, int lane, int tx,
                                         int tb,
                                         float (&acc)[4][kRB][4]) {
  using G = StepTile<BB, BH>;
  const float* ws = stage;
  const float* vs = stage + 3 * kStepKC * BH;
#pragma unroll 2
  for (int kk = lane; kk < kStepKC; kk += G::kLanes) {
    float4 wv[3];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      wv[g] = *reinterpret_cast<const float4*>(ws + (g * kStepKC + kk) * BH +
                                               4 * tx);
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const float v = vs[(tb + G::kRG * i) * G::kVS + kk];
      fma4(acc[0][i], v, wv[0]);
      fma4(acc[1][i], v, wv[1]);
      fma4(acc[NG][i], v, wv[2]);
    }
  }
}

template <int BB, int BH, bool VEC>
__global__ void __launch_bounds__(kStepThreads) gru_step_kernel(StepArgs p) {
  using G = StepTile<BB, BH>;
  extern __shared__ __align__(16) float step_smem[];
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
      step_load<BB, BH, VEC>(step_smem + s * G::kStage, p, cb + s, cx, b0, j0);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    hopper::cp_async_wait<kStepStages - 2>();  // chunk `it` has landed
    __syncthreads();  // ... for every thread, and stage it - 1 is free
    if (it + kStepStages - 1 < n)
      step_load<BB, BH, VEC>(
          step_smem + ((it + kStepStages - 1) % kStepStages) * G::kStage, p,
          cb + it + kStepStages - 1, cx, b0, j0);
    hopper::cp_async_commit();
    const float* stage = step_smem + (it % kStepStages) * G::kStage;
    if (cb + it < cx)
      step_fma<BB, BH, 2>(stage, lane, tx, tb, acc);
    else
      step_fma<BB, BH, 3>(stage, lane, tx, tb, acc);
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  // the k-lanes' sums, one set at a time, added in lane order
  float* red = step_smem;
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
        p.out[o] = gru_update(acc[0][i][c], acc[1][i][c], acc[2][i][c],
                              acc[3][i][c], p.br[j], p.bz[j], p.bnx[j],
                              p.bnh[j], p.h[o]);
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
__global__ void __launch_bounds__(256) gru_sum_kernel(StepArgs p) {
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
  p.out[o] = gru_update(a[0], a[1], a[2], a[3], p.br[j], p.bz[j], p.bnx[j],
                        p.bnh[j], p.h[o]);
}

template <int BB, int BH, bool VEC>
cudaError_t step_smem_attr() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gru_step_kernel<BB, BH, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, StepTile<BB, BH>::kSmem);
  return attr;
}

template <int BB, int BH, bool VEC>
int launch_step(const StepArgs& p, cudaStream_t s) {
  using G = StepTile<BB, BH>;
  if (const cudaError_t e = step_smem_attr<BB, BH, VEC>())
    return static_cast<int>(e);
  const dim3 grid(cdiv(p.H, BH), p.split, cdiv(p.B, BB));
  gru_step_kernel<BB, BH, VEC><<<grid, kStepThreads, G::kSmem, s>>>(p);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (p.split == 1) return 0;
  const size_t plane = static_cast<size_t>(p.B) * p.H;
  gru_sum_kernel<<<static_cast<unsigned>((plane + 255) / 256), 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a SM of the step kernel, at its dynamic shared memory.
template <int BB, int BH, bool VEC>
int step_occupancy(int* blocks) {
  if (const cudaError_t e = step_smem_attr<BB, BH, VEC>())
    return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gru_step_kernel<BB, BH, VEC>, kStepThreads,
      StepTile<BB, BH>::kSmem));
}

template <int BB_, int BH_, bool VEC_>
struct StepKey {
  static constexpr int BB = BB_, BH = BH_;
  static constexpr bool VEC = VEC_;
};

// f(StepKey<BB, BH, VEC>{}) for a tile (bb, bh) and route this library
// was built for, else kNoSuchKernel.
template <bool VEC, typename F>
int with_tile(int bb, int bh, F&& f) {
  if (bb == 16 && bh == 16) return f(StepKey<16, 16, VEC>{});
  if (bb == 16 && bh == 32) return f(StepKey<16, 32, VEC>{});
  if (bb == 16 && bh == 64) return f(StepKey<16, 64, VEC>{});
  if (bb == 32 && bh == 16) return f(StepKey<32, 16, VEC>{});
  if (bb == 32 && bh == 32) return f(StepKey<32, 32, VEC>{});
  if (bb == 32 && bh == 64) return f(StepKey<32, 64, VEC>{});
  return kNoSuchKernel;
}

template <typename F>
int with_step(int bb, int bh, int vec, F&& f) {
  return vec ? with_tile<true>(bb, bh, f) : with_tile<false>(bb, bh, f);
}

// ===========================================================================
// K4
// ===========================================================================

struct SeqArgs {
  const float* g;      // (T, gb, 3H): x [Wr|Wz|Wn] + [br|bz|bnx], from row 0
                       // of this launch's batch rows
  const float* h0;     // (B, H)
  const float* upack;  // (gridDim.x, Hp, 3, cpb): each block's U panel
  const float* bnh;    // (H)
  float* buf;          // (2, B, H): the hidden state, used in turn
  float* out;          // (B, H): the last step's h
  unsigned* bar;       // the grid barrier's counter, 0 at the launch
  int T, B, gb, H, Hp, cpb, rows_res, lanes;  // gb: G's rows a step
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
// chunk: hs its h rows (stride kSeqKC + 4), u its U rows (3 cpb a row),
// both in shared memory.
__device__ __forceinline__ void seq_fma(const float* __restrict__ hs,
                                        const float* __restrict__ u, int q0,
                                        int q1, int c, int tb, int rg, int cpb,
                                        float (&acc)[kSeqRB][3]) {
  const int row = 3 * cpb;
  for (int q = q0; q < q1; q += 4) {
    float4 hv[kSeqRB];
#pragma unroll
    for (int i = 0; i < kSeqRB; ++i)
      hv[i] = *reinterpret_cast<const float4*>(hs + (tb + rg * i) * (kSeqKC + 4)
                                               + q);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float* ur = u + (q + s) * row + c;
      const float u0 = ur[0], u1 = ur[cpb], u2 = ur[2 * cpb];
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
template <bool VEC>
__device__ __forceinline__ void seq_issue(float* stage, const float* hin,
                                          const float* panel, int k0,
                                          const SeqArgs& p, int bp) {
  constexpr int VW = VEC ? 4 : 1;
  constexpr int PER_ROW = kSeqKC / VW;
  for (int i = threadIdx.x; i < bp * PER_ROW; i += kSeqThreads) {
    const int b = i / PER_ROW, q = (i % PER_ROW) * VW;
    const int gk = k0 + q;
    const bool ok = b < p.B && gk < p.H;
    float* dst = stage + b * (kSeqKC + 4) + q;
    const float* src = hin + static_cast<size_t>(b) * p.H + gk;
    if constexpr (VEC)
      hopper::cp_async<16>(dst, ok ? src : hin, ok ? 16 : 0);
    else
      *dst = ok ? __ldcg(src) : 0.0f;
  }
  if (k0 < p.rows_res) return;
  const int row = 3 * p.cpb;
  float* us = stage + bp * (kSeqKC + 4);
  const float* src = panel + static_cast<size_t>(k0) * row;
  for (int i = 4 * threadIdx.x; i < kSeqKC * row; i += 4 * kSeqThreads)
    hopper::cp_async<16>(us + i, src + i, 16);
}

template <bool VEC>
__global__ void __launch_bounds__(kSeqThreads) gru_seq_kernel(SeqArgs p) {
  extern __shared__ __align__(16) float seq_smem[];
  const int rg = (p.B + kSeqRB - 1) / kSeqRB;  // thread rows
  const int bp = rg * kSeqRB;               // staged rows, padded with zeros
  const int units = p.cpb * rg;
  const int lane = threadIdx.x / units, unit = threadIdx.x % units;
  const int c = unit % p.cpb, tb = unit / p.cpb;
  const bool active = lane < p.lanes;
  const int kper = kSeqKC / p.lanes;
  const int row = 3 * p.cpb;
  const int c0 = blockIdx.x * p.cpb;

  // the resident rows of this block's U panel, then the ring of staged
  // chunks (which the k-lane sums reuse at the end of a step)
  const float* panel = p.upack + static_cast<size_t>(blockIdx.x) * p.Hp * row;
  float* us = seq_smem;
  float* ring = seq_smem + (p.rows_res * row + 3) / 4 * 4;
  const int stage_floats =
      bp * (kSeqKC + 4) + (p.rows_res < p.Hp ? kSeqKC * row : 0);
  float* red = ring;
  for (int i = threadIdx.x; i < p.rows_res * row; i += kSeqThreads)
    us[i] = __ldg(panel + i);
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
  for (int t = 0; t < p.T; ++t) {
    const float* hin = t ? p.buf + ((t - 1) & 1) * plane : p.h0;
    float* hout = t == p.T - 1 ? p.out : p.buf + (t & 1) * plane;
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
        seq_issue<VEC>(ring + s * stage_floats, hin, panel,
                       (first + s) % nchunks * kSeqKC, p, bp);
      hopper::cp_async_commit();
    }
    for (int ci = 0; ci < nchunks; ++ci) {
      hopper::cp_async_wait<kSeqStages - 2>();  // chunk ci has landed
      __syncthreads();  // ... for every thread, and stage ci - 1 is free
      const int next = ci + kSeqStages - 1;
      if (next < nchunks)
        seq_issue<VEC>(ring + (next % kSeqStages) * stage_floats, hin, panel,
                       (first + next) % nchunks * kSeqKC, p, bp);
      hopper::cp_async_commit();
      const int k0 = (first + ci) % nchunks * kSeqKC;
      const float* stage = ring + (ci % kSeqStages) * stage_floats;
      const float* u = k0 < p.rows_res ? us + k0 * row
                                       : stage + bp * (kSeqKC + 4);
      if (active)
        seq_fma(stage, u, lane * kper, (lane + 1) * kper, c, tb, rg, p.cpb,
                acc);
      if (mine && ej >= k0 && ej < k0 + kSeqKC)
        hold = stage[eb * (kSeqKC + 4) + ej - k0];
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
                            r * (sn + __ldg(p.bnh + j)));
      const float h = first_elem ? hold : __ldcg(hin + o);
      hout[o] = (1.0f - z) * n + z * h;
    }
    // the k-lane sums and the next step's first stages share memory: the
    // barrier's __syncthreads comes between them
    if (t + 1 < p.T) grid_barrier(p.bar, (t + 1u) * gridDim.x);
  }
}

}  // namespace

// One K3 step: [gru_step_kernel, then gru_sum_kernel when split > 1] on
// `stream`.  All pointers are f32, contiguous, on one device; out is not h;
// part holds 4 x split x B x H floats when split > 1.  vec: 16-byte copies
// (E % 4 == H % 4 == 0, x, h, W*, U* 16-byte aligned).  Returns
// cudaGetLastError() after each launch (the first that is not 0), or -1
// for a tile this library was not built for.
extern "C" int repro_gru_cell(int bb, int bh, int vec, int split,
                              const void* x, const void* h, const void* wr,
                              const void* ur, const void* wz, const void* uz,
                              const void* wn, const void* un, const void* br,
                              const void* bz, const void* bnx, const void* bnh,
                              void* out, void* part, int B, int E, int H,
                              void* stream) {
  if (split < 1 || (split > 1 && !part)) return kNoSuchKernel;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const StepArgs p{f(x),   f(h),   {f(wr), f(wz), f(wn)}, {f(ur), f(uz), f(un)},
                   f(br),  f(bz),  f(bnx), f(bnh), static_cast<float*>(out),
                   static_cast<float*>(part), B, E, H, split};
  const auto s = static_cast<cudaStream_t>(stream);
  return with_step(bb, bh, vec, [&](auto k) {
    using K = decltype(k);
    return launch_step<K::BB, K::BH, K::VEC>(p, s);
  });
}

// Resident blocks a SM of K3's step kernel at tile (bb, bh) and route vec
// into *blocks (one int), as the occupancy calculator gives them for the
// registers this build took: kernels/gru.py::gru_split's cost model waves
// the step's grid over these.  Returns 0, -1 for a tile this library was
// not built for, else the CUDA error.
extern "C" int repro_gru_cell_occupancy(int bb, int bh, int vec,
                                        void* blocks) {
  return with_step(bb, bh, vec, [&](auto k) {
    using K = decltype(k);
    return step_occupancy<K::BB, K::BH, K::VEC>(static_cast<int*>(blocks));
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

// The dynamic shared memory gru_seq_kernel lays out: the resident rows of
// the U panel (rounded up to 16 bytes), then the ring of kSeqStages chunks,
// which the k-lane sums reuse.
static long long seq_smem_bytes(int B, int cpb, int rows_res, int lanes, int Hp) {
  const long long rg = cdiv(B, kSeqRB), row = 3LL * cpb;
  const long long stage =
      rg * kSeqRB * (kSeqKC + 4) + (rows_res < Hp ? kSeqKC * row : 0);
  const long long red = lanes * cpb * rg * 3 * kSeqRB;
  const long long ring = kSeqStages * stage > red ? kSeqStages * stage : red;
  return 4 * ((rows_res * row + 3) / 4 * 4 + ring);
}

// K4's recurrence over B <= kSeqMaxB batch rows: one cooperative launch of
// `blocks` blocks running all T steps (kernels/gru.py::gru_seq_launch sets
// blocks, cpb, rows_res, lanes and smem; the wrapper launches once for each
// group of at most kSeqMaxB rows).  g: the group's first row of G, a
// (T, gb, 3H) f32 array; h0, out: (B, H); upack: (blocks, Hp, 3, cpb) f32;
// buf: 2 B H f32 scratch; bar: one 32-bit counter of scratch, zeroed here.
// vec: 16-byte loads of h (H % 4 == 0, h0 16-byte aligned).  Returns
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident,
// -1 for arguments the kernel does not take (smem smaller than its layout
// among them), else cudaGetLastError() after the launch.
extern "C" int repro_gru_seq(int vec, int blocks, int cpb, int rows_res,
                             int lanes, int smem, const void* g,
                             const void* h0, const void* upack,
                             const void* bnh, void* buf, void* out, void* bar,
                             int T, int B, int gb, int H, int Hp,
                             void* stream) {
  const int rg = (B + kSeqRB - 1) / kSeqRB;
  if (B < 1 || B > kSeqMaxB || gb < B || T < 1 || H < 1 || cpb < 1 ||
      blocks < 1 || 1LL * blocks * cpb < H || lanes < 1 ||
      cpb * rg * lanes > kSeqThreads || kSeqKC % (4 * lanes) != 0 ||
      Hp % kSeqKC != 0 || Hp < H || rows_res < 0 || rows_res > Hp ||
      (rows_res != Hp && rows_res % kSeqKC != 0) ||
      smem < seq_smem_bytes(B, cpb, rows_res, lanes, Hp))
    return kNoSuchKernel;
  void (*kernel)(SeqArgs) = vec ? gru_seq_kernel<true> : gru_seq_kernel<false>;
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
  const auto s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s)) != cudaSuccess)
    return static_cast<int>(e);
  SeqArgs p{static_cast<const float*>(g),     static_cast<const float*>(h0),
            static_cast<const float*>(upack), static_cast<const float*>(bnh),
            static_cast<float*>(buf),         static_cast<float*>(out),
            static_cast<unsigned*>(bar),      T, B, gb, H, Hp, cpb, rows_res,
            lanes};
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(blocks), dim3(kSeqThreads), args, smem,
                                  s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
