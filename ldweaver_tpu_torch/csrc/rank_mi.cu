// K1: the rank-compacted MI tile on Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel ops/pallas_rank_mi.py
// (`_kernel_body`, general epilogue) and the XLA-only telescoped "pure"
// epilogue of parallel/fast_sweep.py `_rank_tile_mi` (fast_sweep.py:223-240).
//
// For a bucket with static (RF, RT) (the largest allele rank of the from-
// and to-blocks) one output element (i, j) of the [nf, nt] tile needs
//   * the (RF-1)(RT-1) weighted contingency counts
//       c[x][y] = sum_t sum_s wparts[t][s] * 1[code(s, fs+i) == x]
//                                           * 1[code(s, ts+j) == y]
//     over the first n_terms (1 to 3) bf16 terms t of the f32 Hamming
//     weights (`precision_terms` of the JAX sweep; the marginals px / py
//     and neff stay exact f32 sums of the weights whatever n_terms is),
//   * the last rank row and column by marginal closure from px / py,
//   * the gated RF*RT-term log epilogue (general) or, for pure buckets, the
//     telescoped entropy form with precomputed row / column terms.
//
// Design.  The counts are one bf16 tensor-core GEMM over the stacked planes
// (rows (x, i), columns (y, j), depth (t, s)), computed by mma_planes.cuh:
// a 256-thread block stages the u8 codes of its rows and columns with
// cp.async from the resident SEQUENCE-MAJOR [nseq, ld] tensor at column
// offsets fs / ts (no per-tile transpose), expands each 64-genome chunk once
// into one-hot operand tiles in shared memory, and 8 warps multiply them on
// mma.sync.m16n8k16 with f32 accumulation.  The block tile shrinks as the
// planes grow (mma_planes::Planes: 128 x 128 for one plane, 32 x 32 for 9
// to 16) to keep at most 64 counts a thread, so two blocks share an SM.
// The counts then pass through shared memory to the epilogue below, which
// gives each thread whole outputs in turn (closure, logs, one coalesced
// store).  Rf == 1 or Rt == 1 needs no contraction: the tile is the
// marginals.
//
// What bounds it on an H100 SXM (B = 4096): the contraction,
// 2 * B^2 * n_terms * S per plane at 989 TFLOP/s: at three terms 62.7 us
// a plane at S = 616 and 104.2 us at S = 1024 (the LR sweep's (2,3)
// buckets: 0.2085 ms), a third of that at one term; writing the 64 MB f32
// tile takes 20 us at 3.35 TB/s.  So every counted bucket is bound by
// operations.
//
// Why mma.sync and not wgmma: the warp-level instruction's fragment layouts
// are fixed by the PTX ISA (ldmatrix delivers them straight from padded
// rows), so it needs no shared-memory descriptor, no swizzle contract and
// no warpgroup fences.  It cannot reach wgmma's full rate.  Left on the
// table: a wgmma mainloop (one function, mma_planes::Planes::run), TMA
// loads, an expansion of chunk c+1 that overlaps the products of chunk c
// inside a block (now only the other block of the SM overlaps it), and a
// persistent grid that overlaps one tile's epilogue with the next tile's
// loads.  The general epilogue (two IEEE divisions and a logf a cell) is a
// large share of the general buckets' time.
//
// No fast-math: the epilogue subtracts p*log(p) aggregates of similar size,
// so it uses the precise logf and IEEE division.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_planes.cuh"

namespace {

using mma_planes::kThreads;

template <int RF, int RT, bool PURE>
__global__ void __launch_bounds__(kThreads, mma_planes::kBlocksPerSM)
rank_mi_kernel(const uint8_t* __restrict__ codes, long long ld, long long fs,
               long long ts, int nf, int nt, int S,
               const uint16_t* __restrict__ wparts, int n_terms,
               const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ r_f, const float* __restrict__ r_t,
               float neff, float* __restrict__ out, bool vec) {
  constexpr bool COUNT = RF >= 2 && RT >= 2;
  using P = mma_planes::Planes<COUNT ? RF - 1 : 1, COUNT ? RT - 1 : 1>;
  constexpr int BM = P::BM, BN = P::BN;

  __shared__ float s_px[RF][BM];
  __shared__ float s_py[RT][BN];
  __shared__ float s_rf[BM];
  __shared__ float s_rt[BN];
  __shared__ float s_lx[BM];
  __shared__ float s_ly[BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // marginals and allele counts of this tile's rows and columns
  for (int k = tid; k < RF * BM; k += kThreads) {
    const int x = k / BM, c = k % BM;
    s_px[x][c] = row0 + c < nf ? px[(long long)x * nf + row0 + c] : 0.f;
  }
  for (int k = tid; k < RT * BN; k += kThreads) {
    const int y = k / BN, c = k % BN;
    s_py[y][c] = col0 + c < nt ? py[(long long)y * nt + col0 + c] : 0.f;
  }
  for (int c = tid; c < BM; c += kThreads)
    s_rf[c] = row0 + c < nf ? r_f[row0 + c] : 0.f;
  for (int c = tid; c < BN; c += kThreads)
    s_rt[c] = col0 + c < nt ? r_t[col0 + c] : 0.f;
  __syncthreads();

  if constexpr (PURE) {
    // row / column terms of the telescoped epilogue (fast_sweep.py:232-239)
    for (int c = tid; c < BM; c += kThreads) {
      float lx = 0.f;
#pragma unroll
      for (int x = 0; x < RF; ++x) {
        const float p = s_px[x][c] + float(0.5 * RT);
        lx = lx + logf(p) * p;
      }
      s_lx[c] = lx;
    }
    for (int c = tid; c < BN; c += kThreads) {
      float ly = 0.f;
#pragma unroll
      for (int y = 0; y < RT; ++y) {
        const float p = s_py[y][c] + float(0.5 * RF);
        ly = ly + logf(p) * p;
      }
      s_ly[c] = ly;
    }
  }

  __syncthreads();

  extern __shared__ uint4 planes_smem[];
  if constexpr (COUNT)
    P::run(planes_smem, codes, ld, fs, ts, row0, col0, nf, nt, S, wparts,
           n_terms, vec);

  // one output a thread at a time, neighbouring threads on neighbouring
  // columns
  for (int k = tid; k < BM * BN; k += kThreads) {
    const int li = k / BN, lj = k % BN;
    const int i = row0 + li, j = col0 + lj;
    if (i >= nf || j >= nt) continue;
    // all RF x RT counts via marginal closure (pallas_rank_mi.py:99-120)
    float cnt[RF][RT];
    if constexpr (RF == 1) {
#pragma unroll
      for (int y = 0; y < RT; ++y) cnt[0][y] = s_py[y][lj];
    } else if constexpr (RT == 1) {
#pragma unroll
      for (int x = 0; x < RF; ++x) cnt[x][0] = s_px[x][li];
    } else {
#pragma unroll
      for (int x = 0; x < RF - 1; ++x)
#pragma unroll
        for (int y = 0; y < RT - 1; ++y)
          cnt[x][y] = P::count(planes_smem, x, y, li, lj);
#pragma unroll
      for (int x = 0; x < RF - 1; ++x) {
        float s = cnt[x][0];
#pragma unroll
        for (int y = 1; y < RT - 1; ++y) s = s + cnt[x][y];
        cnt[x][RT - 1] = s_px[x][li] - s;
      }
#pragma unroll
      for (int y = 0; y < RT; ++y) {
        float s = cnt[0][y];
#pragma unroll
        for (int x = 1; x < RF - 1; ++x) s = s + cnt[x][y];
        cnt[RF - 1][y] = s_py[y][lj] - s;
      }
    }

    float mi;
    if constexpr (PURE) {
      // fast_sweep.py:223-240
      const float den_s = neff + float(0.5 * RF * RT);
      const float logden = logf(den_s);
      const float invden = 1.0f / den_s;
      float ent = 0.f;
#pragma unroll
      for (int x = 0; x < RF; ++x)
#pragma unroll
        for (int y = 0; y < RT; ++y) {
          const float p = cnt[x][y] + 0.5f;
          ent = ent + p * logf(p);
        }
      mi = (ent - s_lx[li] - s_ly[lj] + den_s * logden) * invden;
    } else {
      // pallas_rank_mi.py:89-136
      const float rf = s_rf[li];
      const float rt = s_rt[lj];
      const float den = neff + 0.5f * (rf * rt);
      const float rxy = 0.25f * (rf * rt);
      mi = 0.f;
#pragma unroll
      for (int x = 0; x < RF; ++x) {
        const float gate_x = x < rf ? 1.f : 0.f;
        const float pxv = s_px[x][li];
        const float pxr = pxv * (0.5f * rf);
#pragma unroll
        for (int y = 0; y < RT; ++y) {
          const float pyv = s_py[y][lj];
          const float pxy = cnt[x][y] + 0.5f;
          const float denom = pxv * pyv + rxy + pxr + pyv * (0.5f * rt);
          const float uq = gate_x * (y < rt ? 1.f : 0.f);
          mi = mi + uq * pxy / den * logf(pxy / denom * den);
        }
      }
    }
    out[(long long)i * nt + j] = mi;
  }
}

template <int RF, int RT, bool PURE>
int launch(const uint8_t* codes, long long ld, long long fs, long long ts,
           int nf, int nt, int S, const uint16_t* wparts, int n_terms,
           const float* px, const float* py, const float* r_f,
           const float* r_t, float neff, float* out, cudaStream_t stream) {
  constexpr bool COUNT = RF >= 2 && RT >= 2;
  using P = mma_planes::Planes<COUNT ? RF - 1 : 1, COUNT ? RT - 1 : 1>;
  // the telescoped epilogue needs both sides polymorphic (fast_sweep.py:223)
  constexpr bool PU = PURE && COUNT;
  const dim3 grid((nt + P::BN - 1) / P::BN, (nf + P::BM - 1) / P::BM);
  const bool vec = mma_planes::vec_ok(codes, ld, fs, ts, wparts, S);
  const auto kernel = rank_mi_kernel<RF, RT, PU>;
  const int smem = COUNT ? P::kSmemBytes : 0;
  if (smem > 48 * 1024) {  // above 48 KB only with the opt-in attribute
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(codes, ld, fs, ts, nf, nt, S,
                                           wparts, n_terms, px, py, r_f, r_t,
                                           neff, out, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch K1 on `stream` for one [nf, nt] tile over the n_terms rows of
// wparts [n_terms, S].  Returns the CUDA error of the launch (0 on
// success), or -1 when (Rf, Rt) is outside 1..5 or n_terms outside 1..3.
int ldw_rank_mi_tile(int Rf, int Rt, int pure, const void* codes,
                     long long ld, long long fs, long long ts, int nf, int nt,
                     int S, const void* wparts, int n_terms, const void* px,
                     const void* py, const void* r_f, const void* r_t,
                     float neff, void* out, void* stream) {
  if (n_terms < 1 || n_terms > mma_planes::kTerms) return -1;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* w = static_cast<const uint16_t*>(wparts);
  const auto* pxp = static_cast<const float*>(px);
  const auto* pyp = static_cast<const float*>(py);
  const auto* rfp = static_cast<const float*>(r_f);
  const auto* rtp = static_cast<const float*>(r_t);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define LDW_CASE(A, B)                                                     \
  case (A) * 8 + (B):                                                      \
    return pure ? launch<A, B, true>(c, ld, fs, ts, nf, nt, S, w, n_terms, \
                                     pxp, pyp, rfp, rtp, neff, o, st)      \
                : launch<A, B, false>(c, ld, fs, ts, nf, nt, S, w, n_terms,\
                                      pxp, pyp, rfp, rtp, neff, o, st);
#define LDW_ROW(A) \
  LDW_CASE(A, 1) LDW_CASE(A, 2) LDW_CASE(A, 3) LDW_CASE(A, 4) LDW_CASE(A, 5)
  switch (Rf * 8 + Rt) {
    LDW_ROW(1)
    LDW_ROW(2)
    LDW_ROW(3)
    LDW_ROW(4)
    LDW_ROW(5)
    default:
      return -1;
  }
#undef LDW_ROW
#undef LDW_CASE
}

const char* ldw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
