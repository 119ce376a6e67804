// K3: one fused GRU step, h' = GRU(x, h), for sm_90a.
//
//   r  = sigmoid(x Wr + h Ur + br)
//   z  = sigmoid(x Wz + h Uz + bz)
//   n  = tanh(x Wn + r (h Un + bnh) + bnx)
//   h' = (1 - z) n + z h
//
// Replaces: src/repro/kernels/gru.py::gru_cell (the Pallas TPU kernel
// `_gru_kernel`, one program per (bb, bh) tile with whole (E, bh) and
// (Hp, bh) weight panels resident in VMEM).  The step loop of
// src/repro/kernels/gru.py::gru_seq (K4) launches this kernel once a step.
//
// What bounds it on an H100 (data-sheet peaks): bytes.  A step reads six
// weight matrices, 3 (E H + H H) f32 values: 77.8 MB at E = H = 1792, which
// is 23.2 us at 3.35 TB/s and more than the 50 MB L2, so every step reads
// them from device memory again.  The batch is at most 32 rows, so each
// weight feeds at most 2 x 32 FLOPs: far below the card's ratio of
// operations to bytes.
//
// What the design does about it: each weight is read from device memory by
// exactly one block.  A block owns all BB (>= batch) rows of a BH-wide
// column slice of h', so the grid is H / BH blocks, and it streams its
// slice of the six weight panels through shared memory in KC-deep chunks
// (a whole 1792 x 256 f32 panel, as the Pallas kernel stages it, is 1.8 MB
// and does not fit).  The next chunk is loaded into registers while the
// current one is used, so each thread keeps 3 x 8 weight loads in flight.
// Four f32 accumulators per output element (x Wr + h Ur, x Wz + h Uz, x Wn,
// h Un) stay in registers, and the gate epilogue runs on them before the
// one store.  `h` is one pointer read two ways: full rows for the U
// products, and the (b, j) element for the update.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkElems = 2048;  // KC x BH weights per matrix and chunk

struct GruArgs {
  const float* x;  // (B, E)
  const float* h;  // (B, H)
  const float* wr;
  const float* ur;
  const float* wz;
  const float* uz;
  const float* wn;
  const float* un;
  const float* br;
  const float* bz;
  const float* bnx;
  const float* bnh;
  float* out;  // (B, H), never the same buffer as h
  int B, E, H;
};

template <int BB, int BH>
struct Tile {
  static constexpr int KC = kChunkElems / BH;       // reduction chunk depth
  static constexpr int RG = kThreads / BH;          // thread rows
  static constexpr int RB = BB / RG;                // rows of h' per thread
  static constexpr int WPT = KC * BH / kThreads;    // weights per thread
  static constexpr int VPT = BB * KC / kThreads;    // x or h values per thread
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Loads the chunk [k0, k0 + KC) of v (rows b0.., row stride kdim) and of the
// three (kdim, H) weight matrices (columns j0..) into registers, zero-filling
// outside the operands.
template <int BB, int BH>
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ v, const float* __restrict__ w0,
    const float* __restrict__ w1, const float* __restrict__ w2, int kdim,
    int B, int H, int b0, int j0, int k0,
    float (&wreg)[3][Tile<BB, BH>::WPT], float (&vreg)[Tile<BB, BH>::VPT]) {
  using T = Tile<BB, BH>;
#pragma unroll
  for (int s = 0; s < T::WPT; ++s) {
    const int idx = threadIdx.x + s * kThreads;
    const int gk = k0 + idx / BH, gj = j0 + idx % BH;
    const bool ok = gk < kdim && gj < H;
    const size_t off = (size_t)gk * H + gj;
    wreg[0][s] = ok ? w0[off] : 0.0f;
    wreg[1][s] = ok ? w1[off] : 0.0f;
    wreg[2][s] = ok ? w2[off] : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < T::VPT; ++s) {
    const int idx = threadIdx.x + s * kThreads;
    const int gb = b0 + idx / T::KC, gk = k0 + idx % T::KC;
    vreg[s] = (gb < B && gk < kdim) ? v[(size_t)gb * kdim + gk] : 0.0f;
  }
}

// acc0 += v W0, acc1 += v W1, acc2 += v W2 over the whole reduction kdim,
// for this thread's RB rows and one column.
template <int BB, int BH>
__device__ __forceinline__ void reduce_phase(
    const float* __restrict__ v, const float* __restrict__ w0,
    const float* __restrict__ w1, const float* __restrict__ w2, int kdim,
    int B, int H, int b0, int j0,
    float (&vs)[BB][Tile<BB, BH>::KC + 1],
    float (&ws)[3][Tile<BB, BH>::KC][BH], float (&acc0)[Tile<BB, BH>::RB],
    float (&acc1)[Tile<BB, BH>::RB], float (&acc2)[Tile<BB, BH>::RB]) {
  using T = Tile<BB, BH>;
  const int tx = threadIdx.x % BH, ty = threadIdx.x / BH;
  float wreg[3][T::WPT], vreg[T::VPT];
  const int chunks = (kdim + T::KC - 1) / T::KC;
  load_chunk<BB, BH>(v, w0, w1, w2, kdim, B, H, b0, j0, 0, wreg, vreg);
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();  // every thread is done reading the previous chunk
#pragma unroll
    for (int s = 0; s < T::WPT; ++s) {
      const int idx = threadIdx.x + s * kThreads;
      const int r = idx / BH, q = idx % BH;
      ws[0][r][q] = wreg[0][s];
      ws[1][r][q] = wreg[1][s];
      ws[2][r][q] = wreg[2][s];
    }
#pragma unroll
    for (int s = 0; s < T::VPT; ++s) {
      const int idx = threadIdx.x + s * kThreads;
      vs[idx / T::KC][idx % T::KC] = vreg[s];
    }
    __syncthreads();
    if (c + 1 < chunks)
      load_chunk<BB, BH>(v, w0, w1, w2, kdim, B, H, b0, j0, (c + 1) * T::KC,
                         wreg, vreg);
#pragma unroll 8
    for (int kk = 0; kk < T::KC; ++kk) {
      const float a = ws[0][kk][tx], b = ws[1][kk][tx], d = ws[2][kk][tx];
#pragma unroll
      for (int i = 0; i < T::RB; ++i) {
        const float vv = vs[ty + T::RG * i][kk];
        acc0[i] = fmaf(vv, a, acc0[i]);
        acc1[i] = fmaf(vv, b, acc1[i]);
        acc2[i] = fmaf(vv, d, acc2[i]);
      }
    }
  }
}

template <int BB, int BH>
__global__ void __launch_bounds__(kThreads) gru_cell_kernel(GruArgs p) {
  using T = Tile<BB, BH>;
  __shared__ float vs[BB][T::KC + 1];  // +1: rows read together differ in bank
  __shared__ float ws[3][T::KC][BH];

  const int tx = threadIdx.x % BH, ty = threadIdx.x / BH;
  const int b0 = blockIdx.y * BB, j0 = blockIdx.x * BH;

  float ar[T::RB], az[T::RB], anx[T::RB], anh[T::RB];
#pragma unroll
  for (int i = 0; i < T::RB; ++i) ar[i] = az[i] = anx[i] = anh[i] = 0.0f;

  reduce_phase<BB, BH>(p.x, p.wr, p.wz, p.wn, p.E, p.B, p.H, b0, j0, vs, ws,
                       ar, az, anx);
  reduce_phase<BB, BH>(p.h, p.ur, p.uz, p.un, p.H, p.B, p.H, b0, j0, vs, ws,
                       ar, az, anh);

  const int j = j0 + tx;
  if (j >= p.H) return;
  const float brj = p.br[j], bzj = p.bz[j], bnxj = p.bnx[j], bnhj = p.bnh[j];
#pragma unroll
  for (int i = 0; i < T::RB; ++i) {
    const int b = b0 + ty + T::RG * i;
    if (b >= p.B) continue;
    const float r = sigmoid(ar[i] + brj);
    const float z = sigmoid(az[i] + bzj);
    const float n = tanhf(anx[i] + r * (anh[i] + bnhj) + bnxj);
    const size_t o = (size_t)b * p.H + j;
    p.out[o] = (1.0f - z) * n + z * p.h[o];
  }
}

template <int BB, int BH>
int launch(const GruArgs& p, cudaStream_t stream) {
  const dim3 grid((p.H + BH - 1) / BH, (p.B + BB - 1) / BB);
  gru_cell_kernel<BB, BH><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are f32, contiguous, on one device; out is not h.  Returns
// cudaGetLastError() after the launch, or -1 for a tile this library was not
// built for.
extern "C" int repro_gru_cell(int bb, int bh, const void* x, const void* h,
                              const void* wr, const void* ur, const void* wz,
                              const void* uz, const void* wn, const void* un,
                              const void* br, const void* bz, const void* bnx,
                              const void* bnh, void* out, int B, int E, int H,
                              void* stream) {
  const GruArgs p{static_cast<const float*>(x),   static_cast<const float*>(h),
                  static_cast<const float*>(wr),  static_cast<const float*>(ur),
                  static_cast<const float*>(wz),  static_cast<const float*>(uz),
                  static_cast<const float*>(wn),  static_cast<const float*>(un),
                  static_cast<const float*>(br),  static_cast<const float*>(bz),
                  static_cast<const float*>(bnx), static_cast<const float*>(bnh),
                  static_cast<float*>(out),       B,
                  E,                              H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bb == 16 && bh == 16) return launch<16, 16>(p, s);
  if (bb == 16 && bh == 32) return launch<16, 32>(p, s);
  if (bb == 32 && bh == 16) return launch<32, 16>(p, s);
  if (bb == 32 && bh == 32) return launch<32, 32>(p, s);
  return -1;
}
