// K3: the 25-allele compat MI tile on Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel ops/pallas_mi.py
// (`_kernel_body`, reached through `mi_tile_pallas`), the tile of the
// reference-parity backends.  For one output element (i, j) of the
// [nf, nt] tile over ACGTN codes (0..4):
//   * the weighted contingency counts
//       n[x][y] = sum_t sum_s wparts[t][s] * 1[code(s, fs+i) == x]
//                                          * 1[code(s, ts+j) == y]
//     over the first n_terms (1 to 3) bf16 terms t of the f32 weights,
//     each term's products summed into the same f32 counts, as the JAX
//     kernel's bf16 products are (pallas_mi.py:58-76);
//   * the full epilogue (pallas_mi.py:78-100), x outer and y inner:
//       den   = neff + 0.5 * r_f * r_t
//       denom = pX*pY + RXY + pX*0.5*r_f + pY*0.5*r_t   (own-site r)
//       MI   += uq_f[x]*uq_t[y] * (n+0.5)/den * log((n+0.5)/denom * den)
//     with RXY read from the [nf, nt] f32 input tile (the compat alias is
//     built on the host by `rxy_term`, never recomputed here).
//
// Plane count: every genome carries exactly one code 0..4 at each site, so
// sum_y n[x][y] = pXc[x] and sum_x n[x][y] = pYc[y], the allele counts
// under the same summed weight terms.  The kernel therefore counts only the
// 16 planes x, y in 0..3 and closes row 4 and column 4 by those counted
// marginals (pxc / pyc), as K1 does for ranks.  They are not the epilogue's
// pX / pY: the JAX kernel counts all 25 planes over the terms but takes its
// marginals from the f32 weights, and below three terms the two differ by
// the bf16 rounding of the weights.  Code 4 (N) and codes outside 0..4
// match no counted plane; the wrapper passes real codes only.
//
// What bounds it on an H100 SXM (4000 x 4000 tile, S = 616): the 16
// count planes as bf16 tensor-core contractions over n_terms weight terms,
// 16 * 2 * F*T * n_terms * S = 946 GFLOP at three terms -> 0.957 ms at 989
// TFLOP/s (0.319 ms at one); the bytes (the RXY tile in and the MI tile
// out, 128 MB) take 38 us.  So it is bound by operations.
//
// Design.  The counts are the contraction the port's MI tile kernels
// share, mma_planes::Planes<4, 4> (mma_planes.cuh), the instantiation of
// K1's (5,5) bucket: a 32 x 32 block tile whose u8 codes are staged with
// cp.async from a SEQUENCE-MAJOR [nseq, ld] tensor at column offsets
// fs / ts, expanded once a chunk into one-hot tiles in shared memory and
// multiplied on bf16 mma.sync.m16n8k16 with f32 accumulation.  The 16
// planes are left in shared memory; the epilogue below gives each thread
// whole outputs in turn, neighbouring threads on neighbouring columns, so
// the RXY reads and the MI stores are coalesced and the counts are read
// without bank conflicts.  At <= 128 registers a thread two blocks share
// an SM, one block's expansion and epilogue beside the other's products.
//
// Left on the table: a wgmma mainloop (one function, Planes::run), TMA
// loads, and a persistent grid that overlaps one block's epilogue (25
// logs and IEEE divisions an output) with the next block's loads.  No
// fast-math: precise logf and IEEE division.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_planes.cuh"

namespace {

using mma_planes::kThreads;

constexpr int kA = 5;  // alleles ACGTN
constexpr int kC = 4;  // counted planes per side (the 5th by closure)
using P = mma_planes::Planes<kC, kC>;
constexpr int kTile = P::BM;  // 32
static_assert(P::BN == kTile, "square block tile");

__global__ void __launch_bounds__(kThreads, mma_planes::kBlocksPerSM)
compat_mi_kernel(const uint8_t* __restrict__ codes, long long ld,
                 long long fs, long long ts, int nf, int nt, int S,
                 const uint16_t* __restrict__ wparts, int n_terms,
                 const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ r_f, const float* __restrict__ r_t,
                 const float* __restrict__ uq_f, const float* __restrict__ uq_t,
                 float neff, const float* __restrict__ rxy,
                 const float* __restrict__ pxc, const float* __restrict__ pyc,
                 float* __restrict__ out, bool vec) {
  __shared__ float s_px[kA][kTile];
  __shared__ float s_py[kA][kTile];
  __shared__ float s_pxc[kC][kTile];
  __shared__ float s_pyc[kA][kTile];
  __shared__ float s_uf[kA][kTile];
  __shared__ float s_ut[kA][kTile];
  __shared__ float s_rf[kTile];
  __shared__ float s_rt[kTile];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  for (int k = tid; k < kA * kTile; k += kThreads) {
    const int x = k / kTile, c = k % kTile;
    const bool in_f = row0 + c < nf, in_t = col0 + c < nt;
    s_px[x][c] = in_f ? px[(long long)x * nf + row0 + c] : 0.f;
    s_uf[x][c] = in_f ? uq_f[(long long)x * nf + row0 + c] : 0.f;
    s_py[x][c] = in_t ? py[(long long)x * nt + col0 + c] : 0.f;
    s_ut[x][c] = in_t ? uq_t[(long long)x * nt + col0 + c] : 0.f;
    if (x < kC) s_pxc[x][c] = in_f ? pxc[(long long)x * nf + row0 + c] : 0.f;
    s_pyc[x][c] = in_t ? pyc[(long long)x * nt + col0 + c] : 0.f;
  }
  for (int c = tid; c < kTile; c += kThreads) {
    s_rf[c] = row0 + c < nf ? r_f[row0 + c] : 0.f;
    s_rt[c] = col0 + c < nt ? r_t[col0 + c] : 0.f;
  }

  // the 16 counted planes of the block tile, left in shared memory; its
  // barriers make the marginals above visible
  extern __shared__ uint4 planes_smem[];
  P::run(planes_smem, codes, ld, fs, ts, row0, col0, nf, nt, S, wparts,
         n_terms, vec);

  // one output a thread at a time, neighbouring threads on neighbouring
  // columns
  for (int k = tid; k < kTile * kTile; k += kThreads) {
    const int li = k / kTile, lj = k % kTile;
    const int i = row0 + li, j = col0 + lj;
    if (i >= nf || j >= nt) continue;
    // the fifth row and column by marginal closure
    float cnt[kA][kA];
#pragma unroll
    for (int x = 0; x < kC; ++x) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < kC; ++y) {
        cnt[x][y] = P::count(planes_smem, x, y, li, lj);
        s = s + cnt[x][y];
      }
      cnt[x][kC] = s_pxc[x][li] - s;
    }
#pragma unroll
    for (int y = 0; y < kA; ++y) {
      float s = 0.f;
#pragma unroll
      for (int x = 0; x < kC; ++x) s = s + cnt[x][y];
      cnt[kC][y] = s_pyc[y][lj] - s;
    }
    // pallas_mi.py:80-99
    const float rf = s_rf[li];
    const float rt = s_rt[lj];
    const float den = neff + 0.5f * rf * rt;
    const float rxy_ij = rxy[(long long)i * nt + j];
    float mi = 0.f;
#pragma unroll
    for (int x = 0; x < kA; ++x) {
      const float pxv = s_px[x][li];
      const float pxr = pxv * (0.5f * rf);
      const float uqx = s_uf[x][li];
#pragma unroll
      for (int y = 0; y < kA; ++y) {
        const float pyv = s_py[y][lj];
        const float pxy = cnt[x][y] + 0.5f;
        const float denom = pxv * pyv + rxy_ij + pxr + pyv * (0.5f * rt);
        const float uq = uqx * s_ut[y][lj];
        mi = mi + uq * pxy / den * logf(pxy / denom * den);
      }
    }
    out[(long long)i * nt + j] = mi;
  }
}

}  // namespace

extern "C" {

// Launch K3 on `stream` for one [nf, nt] tile over the n_terms rows of
// wparts [n_terms, S].  px, py, uq_f, uq_t, pxc, pyc are [5, n] f32 (pxc /
// pyc: the allele counts under the summed terms, for the closure); rxy is
// the [nf, nt] f32 RXY tile.  Returns the CUDA error of the launch (0 on
// success), or -1 when n_terms is outside 1..3.
int ldw_compat_mi_tile(const void* codes, long long ld, long long fs,
                       long long ts, int nf, int nt, int S,
                       const void* wparts, int n_terms, const void* px,
                       const void* py, const void* r_f, const void* r_t,
                       const void* uq_f, const void* uq_t, float neff,
                       const void* rxy, const void* pxc, const void* pyc,
                       void* out, void* stream) {
  if (n_terms < 1 || n_terms > mma_planes::kTerms) return -1;
  const dim3 grid((nt + kTile - 1) / kTile, (nf + kTile - 1) / kTile);
  const bool vec = mma_planes::vec_ok(codes, ld, fs, ts, wparts, S);
  constexpr int smem = P::kSmemBytes;
  // above 48 KB only with the opt-in attribute
  const cudaError_t err = cudaFuncSetAttribute(
      compat_mi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  compat_mi_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), ld, fs, ts, nf, nt, S,
      static_cast<const uint16_t*>(wparts), n_terms,
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(r_f),
      static_cast<const float*>(r_t), static_cast<const float*>(uq_f),
      static_cast<const float*>(uq_t), neff, static_cast<const float*>(rxy),
      static_cast<const float*>(pxc), static_cast<const float*>(pyc),
      static_cast<float*>(out), vec);
  return static_cast<int>(cudaGetLastError());
}

const char* ldw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
