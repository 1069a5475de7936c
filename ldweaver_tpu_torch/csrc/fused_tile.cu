// K2: the fused LR stage-1 tile on Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel ops/pallas_fused_tile.py
// (`_kernel_body`, reached through `fused_tile_stage1`), which stands in
// for `_rank_tile_mi` + the LR mask + the chunked-max stage 1 in the scan
// body of parallel/fast_sweep.py `_build_bucket_sweep` (fast_sweep.py:
// 446-464, 285-297).
//
// Scope: r-pure biallelic block pairs (Rf == Rt == 2).  For one output
// element (i, j) of the [nf, nt] tile:
//   * the single count plane
//       c00 = sum_t sum_s wparts[t][s] * 1[code(s, fs+i) == 0]
//                                      * 1[code(s, ts+j) == 0]
//     over the first n_terms (1 to 3) bf16 terms t of the f32 weights, each
//     term's products summed into the same f32 counts, as the JAX kernel's
//     n_terms bf16 dot_generals are (pallas_fused_tile.py:84-92); the
//     marginals and neff stay exact f32 sums of the weights;
//   * the closure c01 = pX0 - c00, c10 = pY0 - c00, c11 = pY1 - c01 and
//     the telescoped epilogue in the JAX cell order
//     (pallas_fused_tile.py:119-140);
//   * the mask: tri = (i > j) | !same, validity of both sites, and the
//     f32 circular length lens = 0.5g - |d - 0.5g| with the branchless
//     d = diff + (diff < 0) * g; cells with lens <= sr_dist or masked are
//     -inf (:142-151);
//   * stage 1: for every 128-column chunk the max and the FIRST in-tile
//     column attaining it (:153-162); an all -inf chunk reports c * 128.
// Only the [nf, nt/128] (value, column) pairs reach device memory.
//
// What bounds it on an H100 SXM (B = 4096, S = 1024 genomes): the count
// plane as a bf16 tensor-core contraction over n_terms weight terms,
// 2 * B^2 * n_terms * S = 103 GFLOP at three terms -> 0.104 ms at 989
// TFLOP/s (0.035 ms at one); the bytes (codes, weights, marginals,
// positions, 2 MB of candidates) take ~3 us.  So it is bound by
// operations.
//
// Design.  The count plane is the contraction the port's MI tile kernels
// share, mma_planes::Planes<1, 1> (mma_planes.cuh): cp.async-staged u8
// codes read from the resident SEQUENCE-MAJOR [nseq, ld] tensor at column
// offsets fs / ts, one-hot tiles expanded in shared memory, bf16
// mma.sync.m16n8k16 with f32 accumulation.  Its one-plane block tile is
// 128 x 128, exactly one stage-1 chunk of 128 rows, so a block owns its
// chunks whole and the chunk max is a block-local reduction over counts
// already in shared memory: each warp takes 16 rows, lane l scans columns
// l, l+32, l+64, l+96 in ascending order with a strict '>' (the first
// maximum), then a 5-step shuffle reduction whose tie rule takes the
// smaller column.  Neighbouring lanes read neighbouring columns, so the
// counts are read without bank conflicts, and the 64 MB f32 tile never
// reaches device memory.  At <= 128 registers a thread two blocks share an
// SM, one block's expansion and epilogue beside the other's products.
//
// Left on the table: a wgmma mainloop (one function, Planes::run), TMA
// loads, and a persistent grid that overlaps one block's epilogue with the
// next block's loads.  No fast-math: the epilogue subtracts p*log(p)
// aggregates of similar size, so it uses the precise logf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_planes.cuh"

namespace {

using mma_planes::kThreads;
using P = mma_planes::Planes<1, 1>;

constexpr int kChunk = 128;  // stage-1 chunk width
constexpr int kRows = P::BM;  // rows of a block
static_assert(P::BN == kChunk, "one block tile is one stage-1 chunk wide");
constexpr int kRowsPerWarp = kRows / (kThreads / 32);

__global__ void __launch_bounds__(kThreads, mma_planes::kBlocksPerSM)
fused_tile_kernel(const uint8_t* __restrict__ codes, long long ld,
                  long long fs, long long ts, int nf, int nt, int S,
                  const uint16_t* __restrict__ wparts, int n_terms,
                  const float* __restrict__ px, const float* __restrict__ py,
                  const int* __restrict__ pos_f, const int* __restrict__ pos_t,
                  const uint8_t* __restrict__ val_f,
                  const uint8_t* __restrict__ val_t, float neff, int same,
                  int g, float half_g, float sr_dist,
                  float* __restrict__ vals, int* __restrict__ cols,
                  bool vec) {
  __shared__ float s_px0[kRows];
  __shared__ float s_lx[kRows];
  __shared__ int s_posf[kRows];
  __shared__ uint8_t s_vf[kRows];
  __shared__ float s_py0[kChunk];
  __shared__ float s_py1[kChunk];
  __shared__ float s_ly[kChunk];
  __shared__ int s_post[kChunk];
  __shared__ uint8_t s_vt[kChunk];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int col0 = chunk * kChunk;

  // row / column terms of the telescoped epilogue (pallas_fused_tile.py:
  // 103-107, 136-138) and the mask inputs
  for (int c = tid; c < kRows; c += kThreads) {
    const int i = row0 + c;
    const bool in = i < nf;
    const float p0 = in ? px[i] : 0.f;
    const float p1 = in ? px[nf + i] : 0.f;
    const float s0 = p0 + 1.0f;
    const float s1 = p1 + 1.0f;
    s_px0[c] = p0;
    s_lx[c] = logf(s0) * s0 + logf(s1) * s1;
    s_posf[c] = in ? pos_f[i] : 0;
    s_vf[c] = in ? val_f[i] : uint8_t(0);
  }
  for (int c = tid; c < kChunk; c += kThreads) {
    const int j = col0 + c;  // nt is a multiple of kChunk
    const float p0 = py[j];
    const float p1 = py[nt + j];
    const float s0 = p0 + 1.0f;
    const float s1 = p1 + 1.0f;
    s_py0[c] = p0;
    s_py1[c] = p1;
    s_ly[c] = logf(s0) * s0 + logf(s1) * s1;
    s_post[c] = pos_t[j];
    s_vt[c] = val_t[j];
  }

  // c00 of the block's 128 x 128 tile, left in shared memory; its barriers
  // make the terms above visible
  extern __shared__ uint4 planes_smem[];
  P::run(planes_smem, codes, ld, fs, ts, row0, col0, nf, nt, S, wparts,
         n_terms, vec);

  const int warp = tid / 32, lane = tid % 32;
  const float den_s = neff + 2.0f;
  const float logden = logf(den_s);
  const float invden = 1.0f / den_s;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int li = warp * kRowsPerWarp + r;
    const int i = row0 + li;
    if (i >= nf) break;  // rows ascend; the same for the whole warp
    const float px0 = s_px0[li];
    const float lx = s_lx[li];
    const int posf = s_posf[li];
    const bool vf = s_vf[li] != 0;
    float best_v = -INFINITY;
    int best_c = col0 + lane;
#pragma unroll
    for (int q = 0; q < kChunk / 32; ++q) {
      const int lj = lane + 32 * q;
      const int j = col0 + lj;
      // closure and epilogue, pallas_fused_tile.py:122-140
      const float c00 = P::count(planes_smem, 0, 0, li, lj);
      const float c01 = px0 - c00;
      const float c10 = s_py0[lj] - c00;
      const float c11 = s_py1[lj] - c01;
      const float p00 = c00 + 0.5f;
      const float p01 = c01 + 0.5f;
      const float p10 = c10 + 0.5f;
      const float p11 = c11 + 0.5f;
      const float ent = p00 * logf(p00) + p01 * logf(p01) +
                        p10 * logf(p10) + p11 * logf(p11);
      const float mi = (ent - lx - s_ly[lj] + den_s * logden) * invden;
      // mask, :145-151
      const bool tri = (i > j) || same == 0;
      const bool ok = tri && vf && s_vt[lj] != 0;
      const int diff = s_post[lj] - posf;
      const int d = diff + (diff < 0 ? g : 0);
      const float lens = half_g - fabsf(static_cast<float>(d) - half_g);
      const float v = (ok && lens > sr_dist) ? mi : -INFINITY;
      // columns ascend with q: a strict '>' keeps the first maximum
      if (v > best_v) {
        best_v = v;
        best_c = j;
      }
    }
    // across the warp; ties take the smaller column
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
      if (ov > best_v || (ov == best_v && oc < best_c)) {
        best_v = ov;
        best_c = oc;
      }
    }
    if (lane == 0) {
      const long long o = static_cast<long long>(i) * (nt / kChunk) + chunk;
      vals[o] = best_v;
      cols[o] = best_c;
    }
  }
}

}  // namespace

extern "C" {

// Launch K2 on `stream` for one [nf, nt] tile -> [nf, nt/128] (value,
// in-tile column) candidates, over the n_terms rows of wparts
// [n_terms, S].  `val_f` / `val_t` are bytes (0 or 1).  Returns the CUDA
// error of the launch (0 on success), or -1 when nt is not a multiple of
// 128 or n_terms is outside 1..3.
int ldw_fused_tile_stage1(const void* codes, long long ld, long long fs,
                          long long ts, int nf, int nt, int S,
                          const void* wparts, int n_terms, const void* px,
                          const void* py,
                          const void* pos_f, const void* pos_t,
                          const void* val_f, const void* val_t, float neff,
                          int same, int g, float half_g, float sr_dist,
                          void* vals, void* cols, void* stream) {
  if (nt % kChunk != 0 || nf <= 0 || nt <= 0) return -1;
  if (n_terms < 1 || n_terms > mma_planes::kTerms) return -1;
  const dim3 grid(nt / kChunk, (nf + kRows - 1) / kRows);
  const bool vec = mma_planes::vec_ok(codes, ld, fs, ts, wparts, S);
  constexpr int smem = P::kSmemBytes;
  // above 48 KB only with the opt-in attribute
  const cudaError_t err = cudaFuncSetAttribute(
      fused_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_tile_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), ld, fs, ts, nf, nt, S,
      static_cast<const uint16_t*>(wparts), n_terms,
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const int*>(pos_f),
      static_cast<const int*>(pos_t), static_cast<const uint8_t*>(val_f),
      static_cast<const uint8_t*>(val_t), neff, same, g, half_g, sr_dist,
      static_cast<float*>(vals), static_cast<int*>(cols), vec);
  return static_cast<int>(cudaGetLastError());
}

const char* ldw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
