// K1: the rank-compacted MI tile on Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel ops/pallas_rank_mi.py
// (`_kernel_body`, general epilogue) and the XLA-only telescoped "pure"
// epilogue of parallel/fast_sweep.py `_rank_tile_mi` (fast_sweep.py:223-240).
//
// For a bucket with static (RF, RT) (the largest allele rank of the from-
// and to-blocks) one output element (i, j) of the [nf, nt] tile needs
//   * the (RF-1)(RT-1) weighted contingency counts
//       c[x][y] = sum_s w[s] * 1[code(s, fs+i) == x] * 1[code(s, ts+j) == y]
//     with w[s] = wparts[0][s] + wparts[1][s] + wparts[2][s] (three bf16
//     terms of the f32 Hamming weights, summed in f32),
//   * the last rank row and column by marginal closure from px / py,
//   * the gated RF*RT-term log epilogue (general) or, for pure buckets, the
//     telescoped entropy form with precomputed row / column terms.
//
// Design (simple and right first): one 256-thread block per TILE x TILE
// output tile, TILE = 16*TM with TM x TM outputs per thread.  The block
// loops over the sequences in chunks of SK, staging the u8 rank codes of
// its rows and columns and the summed weights in shared memory.  Codes are
// read from the resident SEQUENCE-MAJOR [nseq, ld] tensor at column offsets
// fs / ts, so neighbouring threads read neighbouring SNPs and no per-tile
// transpose is needed.  Each output keeps its (RF-1)(RT-1) counts in f32
// registers; TM drops from 4 to 2 when more than 4 counts are needed so the
// accumulators stay at <= 64 registers a thread.
//
// What bounds it on an H100 SXM (B = 4096, S = 616, one count plane):
//   * as a bf16 tensor-core contraction over 3 weight terms,
//     2 * B^2 * 3S = 62 GFLOP -> 63 us at 989 TFLOP/s;
//   * writing the f32 tile, 64 MB -> 20 us at 3.35 TB/s.
// This first version counts on the FP32 pipes (one FMA per count per
// sequence), so it sits well above that bound; a wgmma version takes the
// same inputs (the three bf16 weight terms) and is later work.
// No fast-math: the epilogue subtracts p*log(p) aggregates of similar size,
// so it uses the precise logf and IEEE division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kSeqChunk = 32;

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

template <int RF, int RT, bool PURE, int TM>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
rank_mi_kernel(const uint8_t* __restrict__ codes, long long ld, long long fs,
               long long ts, int nf, int nt, int S,
               const uint16_t* __restrict__ wparts,
               const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ r_f, const float* __restrict__ r_t,
               float neff, float* __restrict__ out) {
  constexpr int TILE = kThreadsY * TM;
  constexpr bool COUNT = RF >= 2 && RT >= 2;
  constexpr int NX = COUNT ? RF - 1 : 1;
  constexpr int NY = COUNT ? RT - 1 : 1;
  constexpr int NT = kThreadsX * kThreadsY;

  __shared__ uint8_t s_cf[kSeqChunk][TILE];
  __shared__ uint8_t s_ct[kSeqChunk][TILE];
  __shared__ float s_w[kSeqChunk];
  __shared__ float s_px[RF][TILE];
  __shared__ float s_py[RT][TILE];
  __shared__ float s_rf[TILE];
  __shared__ float s_rt[TILE];
  __shared__ float s_lx[TILE];
  __shared__ float s_ly[TILE];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;

  // marginals and allele counts of this tile's rows and columns
  for (int k = tid; k < RF * TILE; k += NT) {
    const int x = k / TILE, c = k % TILE;
    s_px[x][c] = row0 + c < nf ? px[(long long)x * nf + row0 + c] : 0.f;
  }
  for (int k = tid; k < RT * TILE; k += NT) {
    const int y = k / TILE, c = k % TILE;
    s_py[y][c] = col0 + c < nt ? py[(long long)y * nt + col0 + c] : 0.f;
  }
  for (int c = tid; c < TILE; c += NT) {
    s_rf[c] = row0 + c < nf ? r_f[row0 + c] : 0.f;
    s_rt[c] = col0 + c < nt ? r_t[col0 + c] : 0.f;
  }
  __syncthreads();

  float acc[TM][TM][NX][NY];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TM; ++b)
#pragma unroll
      for (int x = 0; x < NX; ++x)
#pragma unroll
        for (int y = 0; y < NY; ++y) acc[a][b][x][y] = 0.f;

  if constexpr (COUNT) {
    for (int s0 = 0; s0 < S; s0 += kSeqChunk) {
      // code 0xFF matches no rank: pad sequences and out-of-tile SNPs add 0
      for (int k = tid; k < kSeqChunk * TILE; k += NT) {
        const int s = k / TILE, c = k % TILE;
        const long long gs = s0 + s;
        const bool in_s = gs < S;
        s_cf[s][c] = (in_s && row0 + c < nf) ? codes[gs * ld + fs + row0 + c]
                                             : uint8_t(0xFF);
        s_ct[s][c] = (in_s && col0 + c < nt) ? codes[gs * ld + ts + col0 + c]
                                             : uint8_t(0xFF);
      }
      for (int s = tid; s < kSeqChunk; s += NT) {
        const int gs = s0 + s;
        s_w[s] = gs < S ? (bf16_bits_to_f32(wparts[gs]) +
                           bf16_bits_to_f32(wparts[S + gs])) +
                              bf16_bits_to_f32(wparts[2 * S + gs])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kSeqChunk; ++s) {
        const float w = s_w[s];
        float wx[TM][NX];
        float oy[TM][NY];
#pragma unroll
        for (int a = 0; a < TM; ++a) {
          const uint8_t c = s_cf[s][ty + kThreadsY * a];
#pragma unroll
          for (int x = 0; x < NX; ++x) wx[a][x] = c == x ? w : 0.f;
        }
#pragma unroll
        for (int b = 0; b < TM; ++b) {
          const uint8_t c = s_ct[s][tx + kThreadsX * b];
#pragma unroll
          for (int y = 0; y < NY; ++y) oy[b][y] = c == y ? 1.f : 0.f;
        }
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TM; ++b)
#pragma unroll
            for (int x = 0; x < NX; ++x)
#pragma unroll
              for (int y = 0; y < NY; ++y)
                acc[a][b][x][y] = fmaf(wx[a][x], oy[b][y], acc[a][b][x][y]);
      }
      __syncthreads();
    }
  }

  if constexpr (PURE) {
    // row / column terms of the telescoped epilogue (fast_sweep.py:232-239)
    for (int c = tid; c < TILE; c += NT) {
      float lx = 0.f, ly = 0.f;
#pragma unroll
      for (int x = 0; x < RF; ++x) {
        const float p = s_px[x][c] + float(0.5 * RT);
        lx = lx + logf(p) * p;
      }
#pragma unroll
      for (int y = 0; y < RT; ++y) {
        const float p = s_py[y][c] + float(0.5 * RF);
        ly = ly + logf(p) * p;
      }
      s_lx[c] = lx;
      s_ly[c] = ly;
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int li = ty + kThreadsY * a;
    const int i = row0 + li;
#pragma unroll
    for (int b = 0; b < TM; ++b) {
      const int lj = tx + kThreadsX * b;
      const int j = col0 + lj;
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
          for (int y = 0; y < RT - 1; ++y) cnt[x][y] = acc[a][b][x][y];
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
}

template <int RF, int RT, bool PURE>
int launch(const uint8_t* codes, long long ld, long long fs, long long ts,
           int nf, int nt, int S, const uint16_t* wparts, const float* px,
           const float* py, const float* r_f, const float* r_t, float neff,
           float* out, cudaStream_t stream) {
  constexpr int NC = (RF >= 2 && RT >= 2) ? (RF - 1) * (RT - 1) : 0;
  constexpr int TM = NC <= 4 ? 4 : 2;
  constexpr int TILE = kThreadsY * TM;
  // the telescoped epilogue needs both sides polymorphic (fast_sweep.py:223)
  constexpr bool P = PURE && RF >= 2 && RT >= 2;
  const dim3 grid((nt + TILE - 1) / TILE, (nf + TILE - 1) / TILE);
  const dim3 block(kThreadsX, kThreadsY);
  rank_mi_kernel<RF, RT, P, TM><<<grid, block, 0, stream>>>(
      codes, ld, fs, ts, nf, nt, S, wparts, px, py, r_f, r_t, neff, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch K1 on `stream` for one [nf, nt] tile.  Returns the CUDA error of
// the launch (0 on success), or -1 when (Rf, Rt) is outside 1..5.
int ldw_rank_mi_tile(int Rf, int Rt, int pure, const void* codes,
                     long long ld, long long fs, long long ts, int nf, int nt,
                     int S, const void* wparts, const void* px, const void* py,
                     const void* r_f, const void* r_t, float neff, void* out,
                     void* stream) {
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
    return pure ? launch<A, B, true>(c, ld, fs, ts, nf, nt, S, w, pxp, pyp, \
                                     rfp, rtp, neff, o, st)                \
                : launch<A, B, false>(c, ld, fs, ts, nf, nt, S, w, pxp,    \
                                      pyp, rfp, rtp, neff, o, st);
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
