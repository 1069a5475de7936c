// K3: the 25-allele compat MI tile on Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel ops/pallas_mi.py
// (`_kernel_body`, reached through `mi_tile_pallas`), the tile of the
// reference-parity backends.  For one output element (i, j) of the
// [nf, nt] tile over ACGTN codes (0..4):
//   * the weighted contingency counts
//       n[x][y] = sum_s w[s] * 1[code(s, fs+i) == x] * 1[code(s, ts+j) == y],
//     w[s] the f32 sum of the three bf16 weight terms;
//   * the full epilogue (pallas_mi.py:78-100), x outer and y inner:
//       den   = neff + 0.5 * r_f * r_t
//       denom = pX*pY + RXY + pX*0.5*r_f + pY*0.5*r_t   (own-site r)
//       MI   += uq_f[x]*uq_t[y] * (n+0.5)/den * log((n+0.5)/denom * den)
//     with RXY read from the [nf, nt] f32 input tile (the compat alias is
//     built on the host by `rxy_term`, never recomputed here).
//
// Plane count: every genome carries exactly one code 0..4 at each site, so
// sum_y n[x][y] = pX[x] and sum_x n[x][y] = pY[y].  The kernel therefore
// counts only the 16 planes x, y in 0..3 and closes row 4 and column 4 by
// the marginals, as K1 does for ranks (16/25 of the FMAs).  Codes outside
// 0..4 (the pad code 5 of the TPU wrapper, 0xFF for genomes past S) match
// no plane; the wrapper passes real codes only.
//
// Design (simple and right first): K1's layout.  One 256-thread block per
// 32 x 32 output tile, 2 x 2 outputs a thread, 16 f32 counts each in
// registers (64 accumulators); the block walks the genomes in chunks of 32
// staged in shared memory, codes read from a SEQUENCE-MAJOR [nseq, ld] u8
// tensor at column offsets fs / ts.
//
// What bounds it on an H100 SXM (4000 x 4000 tile, S = 616): the 16
// count planes as bf16 tensor-core contractions over 3 weight terms,
// 16 * 2 * F*T * 3S = 946 GFLOP -> 0.96 ms at 989 TFLOP/s; the bytes (the
// RXY tile in and the MI tile out, 128 MB) take 38 us.  This version counts
// with one FP32 FMA per plane per genome, so it sits well above that bound.
// No fast-math: precise logf and IEEE division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kTM = 2;  // outputs per thread along each side
constexpr int kTile = kThreadsY * kTM;  // 32
constexpr int kSeqChunk = 32;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kA = 5;   // alleles ACGTN
constexpr int kC = 4;   // counted planes per side (the 5th by closure)

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__global__ void __launch_bounds__(kThreads)
compat_mi_kernel(const uint8_t* __restrict__ codes, long long ld,
                 long long fs, long long ts, int nf, int nt, int S,
                 const uint16_t* __restrict__ wparts,
                 const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ r_f, const float* __restrict__ r_t,
                 const float* __restrict__ uq_f, const float* __restrict__ uq_t,
                 float neff, const float* __restrict__ rxy,
                 float* __restrict__ out) {
  __shared__ uint8_t s_cf[kSeqChunk][kTile];
  __shared__ uint8_t s_ct[kSeqChunk][kTile];
  __shared__ float s_w[kSeqChunk];
  __shared__ float s_px[kA][kTile];
  __shared__ float s_py[kA][kTile];
  __shared__ float s_uf[kA][kTile];
  __shared__ float s_ut[kA][kTile];
  __shared__ float s_rf[kTile];
  __shared__ float s_rt[kTile];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  for (int k = tid; k < kA * kTile; k += kThreads) {
    const int x = k / kTile, c = k % kTile;
    const bool in_f = row0 + c < nf, in_t = col0 + c < nt;
    s_px[x][c] = in_f ? px[(long long)x * nf + row0 + c] : 0.f;
    s_uf[x][c] = in_f ? uq_f[(long long)x * nf + row0 + c] : 0.f;
    s_py[x][c] = in_t ? py[(long long)x * nt + col0 + c] : 0.f;
    s_ut[x][c] = in_t ? uq_t[(long long)x * nt + col0 + c] : 0.f;
  }
  for (int c = tid; c < kTile; c += kThreads) {
    s_rf[c] = row0 + c < nf ? r_f[row0 + c] : 0.f;
    s_rt[c] = col0 + c < nt ? r_t[col0 + c] : 0.f;
  }

  float acc[kTM][kTM][kC][kC];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTM; ++b)
#pragma unroll
      for (int x = 0; x < kC; ++x)
#pragma unroll
        for (int y = 0; y < kC; ++y) acc[a][b][x][y] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kSeqChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int k = tid; k < kSeqChunk * kTile; k += kThreads) {
      const int s = k / kTile, c = k % kTile;
      const long long gs = s0 + s;
      const bool in_s = gs < S;
      s_cf[s][c] = (in_s && row0 + c < nf) ? codes[gs * ld + fs + row0 + c]
                                           : uint8_t(0xFF);
      s_ct[s][c] = (in_s && col0 + c < nt) ? codes[gs * ld + ts + col0 + c]
                                           : uint8_t(0xFF);
    }
    for (int s = tid; s < kSeqChunk; s += kThreads) {
      const int gs = s0 + s;
      s_w[s] = gs < S ? (bf16_bits_to_f32(wparts[gs]) +
                         bf16_bits_to_f32(wparts[S + gs])) +
                            bf16_bits_to_f32(wparts[2 * S + gs])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < kSeqChunk; ++s) {
      const float w = s_w[s];
      float wx[kTM][kC];
      float oy[kTM][kC];
#pragma unroll
      for (int a = 0; a < kTM; ++a) {
        const uint8_t c = s_cf[s][ty + kThreadsY * a];
#pragma unroll
        for (int x = 0; x < kC; ++x) wx[a][x] = c == x ? w : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kTM; ++b) {
        const uint8_t c = s_ct[s][tx + kThreadsX * b];
#pragma unroll
        for (int y = 0; y < kC; ++y) oy[b][y] = c == y ? 1.f : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTM; ++b)
#pragma unroll
          for (int x = 0; x < kC; ++x)
#pragma unroll
            for (int y = 0; y < kC; ++y)
              acc[a][b][x][y] = fmaf(wx[a][x], oy[b][y], acc[a][b][x][y]);
    }
  }
  __syncthreads();  // the marginals are visible even when S == 0

#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int li = ty + kThreadsY * a;
    const int i = row0 + li;
#pragma unroll
    for (int b = 0; b < kTM; ++b) {
      const int lj = tx + kThreadsX * b;
      const int j = col0 + lj;
      if (i >= nf || j >= nt) continue;
      // the fifth row and column by marginal closure
      float cnt[kA][kA];
#pragma unroll
      for (int x = 0; x < kC; ++x) {
        float s = 0.f;
#pragma unroll
        for (int y = 0; y < kC; ++y) {
          cnt[x][y] = acc[a][b][x][y];
          s = s + cnt[x][y];
        }
        cnt[x][kC] = s_px[x][li] - s;
      }
#pragma unroll
      for (int y = 0; y < kA; ++y) {
        float s = 0.f;
#pragma unroll
        for (int x = 0; x < kC; ++x) s = s + cnt[x][y];
        cnt[kC][y] = s_py[y][lj] - s;
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
}

}  // namespace

extern "C" {

// Launch K3 on `stream` for one [nf, nt] tile.  px, py, uq_f, uq_t are
// [5, n] f32; rxy is the [nf, nt] f32 RXY tile.  Returns the CUDA error of
// the launch (0 on success).
int ldw_compat_mi_tile(const void* codes, long long ld, long long fs,
                       long long ts, int nf, int nt, int S,
                       const void* wparts, const void* px, const void* py,
                       const void* r_f, const void* r_t, const void* uq_f,
                       const void* uq_t, float neff, const void* rxy,
                       void* out, void* stream) {
  const dim3 grid((nt + kTile - 1) / kTile, (nf + kTile - 1) / kTile);
  const dim3 block(kThreadsX, kThreadsY);
  compat_mi_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), ld, fs, ts, nf, nt, S,
      static_cast<const uint16_t*>(wparts), static_cast<const float*>(px),
      static_cast<const float*>(py), static_cast<const float*>(r_f),
      static_cast<const float*>(r_t), static_cast<const float*>(uq_f),
      static_cast<const float*>(uq_t), neff, static_cast<const float*>(rxy),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* ldw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
