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
//       c00 = sum_s w[s] * 1[code(s, fs+i) == 0] * 1[code(s, ts+j) == 0],
//     w[s] the f32 sum of the three bf16 weight terms;
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
// Design (simple and right first): one 256-thread block per 64-row x
// 128-column tile, so each block owns exactly one stage-1 chunk of its 64
// rows.  A thread holds 4 rows x 8 columns of c00 in registers (columns
// tx + 16*b), counts on the FP32 pipes while the block walks the genomes
// in chunks of 32 staged in shared memory (codes read from the resident
// SEQUENCE-MAJOR [nseq, ld] tensor at column offsets fs / ts: no per-tile
// slice or transpose).  The chunk max is then a per-thread scan over its 8
// columns (ascending, strict '>' keeps the first) and a 16-lane shuffle
// reduction whose tie rule takes the smaller column, so the first-index
// rule holds across threads.
//
// What bounds it on an H100 SXM (B = 4096, S = 1024 genomes): the count
// plane as a bf16 tensor-core contraction over 3 weight terms,
// 2 * B^2 * 3S = 103 GFLOP -> 104 us at 989 TFLOP/s; the bytes (codes,
// weights, marginals, positions, 2 MB of candidates) take ~3 us.  This
// version counts with one FP32 FMA per count per genome, so it sits well
// above that bound; a wgmma count plane is later work.  No fast-math: the
// epilogue subtracts p*log(p) aggregates of similar size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 16;                 // threads along the columns
constexpr int kThreadsY = 16;                 // threads along the rows
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 8;
constexpr int kTileRows = kThreadsY * kRowsPerThread;  // 64
constexpr int kChunk = kThreadsX * kColsPerThread;     // 128 = one chunk
constexpr int kSeqChunk = 32;
constexpr int kThreads = kThreadsX * kThreadsY;

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__global__ void __launch_bounds__(kThreads)
fused_tile_kernel(const uint8_t* __restrict__ codes, long long ld,
                  long long fs, long long ts, int nf, int nt, int S,
                  const uint16_t* __restrict__ wparts,
                  const float* __restrict__ px, const float* __restrict__ py,
                  const int* __restrict__ pos_f, const int* __restrict__ pos_t,
                  const uint8_t* __restrict__ val_f,
                  const uint8_t* __restrict__ val_t, float neff, int same,
                  int g, float half_g, float sr_dist,
                  float* __restrict__ vals, int* __restrict__ cols) {
  __shared__ uint8_t s_cf[kSeqChunk][kTileRows];
  __shared__ uint8_t s_ct[kSeqChunk][kChunk];
  __shared__ float s_w[kSeqChunk];
  __shared__ float s_px0[kTileRows];
  __shared__ float s_lx[kTileRows];
  __shared__ int s_posf[kTileRows];
  __shared__ uint8_t s_vf[kTileRows];
  __shared__ float s_py0[kChunk];
  __shared__ float s_py1[kChunk];
  __shared__ float s_ly[kChunk];
  __shared__ int s_post[kChunk];
  __shared__ uint8_t s_vt[kChunk];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int chunk = blockIdx.x;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = chunk * kChunk;

  // row / column terms of the telescoped epilogue (pallas_fused_tile.py:
  // 103-107, 136-138) and the mask inputs
  for (int c = tid; c < kTileRows; c += kThreads) {
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

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
    for (int b = 0; b < kColsPerThread; ++b) acc[a][b] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kSeqChunk) {
    __syncthreads();  // the previous chunk is consumed
    // code 0xFF matches no rank: pad genomes and rows past nf add 0
    for (int k = tid; k < kSeqChunk * kTileRows; k += kThreads) {
      const int s = k / kTileRows, c = k % kTileRows;
      const long long gs = s0 + s;
      s_cf[s][c] = (gs < S && row0 + c < nf) ? codes[gs * ld + fs + row0 + c]
                                              : uint8_t(0xFF);
    }
    for (int k = tid; k < kSeqChunk * kChunk; k += kThreads) {
      const int s = k / kChunk, c = k % kChunk;
      const long long gs = s0 + s;
      s_ct[s][c] = gs < S ? codes[gs * ld + ts + col0 + c] : uint8_t(0xFF);
    }
    for (int s = tid; s < kSeqChunk; s += kThreads) {
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
      float wx[kRowsPerThread];
      float oy[kColsPerThread];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a)
        wx[a] = s_cf[s][ty + kThreadsY * a] == 0 ? w : 0.f;
#pragma unroll
      for (int b = 0; b < kColsPerThread; ++b)
        oy[b] = s_ct[s][tx + kThreadsX * b] == 0 ? 1.f : 0.f;
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
        for (int b = 0; b < kColsPerThread; ++b)
          acc[a][b] = fmaf(wx[a], oy[b], acc[a][b]);
    }
  }
  __syncthreads();  // the row / column terms are visible even when S == 0

  const float den_s = neff + 2.0f;
  const float logden = logf(den_s);
  const float invden = 1.0f / den_s;
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int li = ty + kThreadsY * a;
    const int i = row0 + li;
    float best_v = -INFINITY;
    int best_c = col0 + tx;
#pragma unroll
    for (int b = 0; b < kColsPerThread; ++b) {
      const int lj = tx + kThreadsX * b;
      const int j = col0 + lj;
      // closure and epilogue, pallas_fused_tile.py:122-140
      const float c00 = acc[a][b];
      const float c01 = s_px0[li] - c00;
      const float c10 = s_py0[lj] - c00;
      const float c11 = s_py1[lj] - c01;
      const float p00 = c00 + 0.5f;
      const float p01 = c01 + 0.5f;
      const float p10 = c10 + 0.5f;
      const float p11 = c11 + 0.5f;
      const float ent = p00 * logf(p00) + p01 * logf(p01) +
                        p10 * logf(p10) + p11 * logf(p11);
      const float mi = (ent - s_lx[li] - s_ly[lj] + den_s * logden) * invden;
      // mask, :145-151
      const bool tri = (i > j) || same == 0;
      const bool ok = tri && s_vf[li] != 0 && s_vt[lj] != 0;
      const int diff = s_post[lj] - s_posf[li];
      const int d = diff + (diff < 0 ? g : 0);
      const float lens = half_g - fabsf(static_cast<float>(d) - half_g);
      const float v = (ok && lens > sr_dist) ? mi : -INFINITY;
      // columns ascend with b: a strict '>' keeps the first maximum
      if (v > best_v) {
        best_v = v;
        best_c = j;
      }
    }
    // the 16 threads of one row share a half warp (lane = 16 * (ty & 1) +
    // tx); ties take the smaller column
#pragma unroll
    for (int off = kThreadsX / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
      if (ov > best_v || (ov == best_v && oc < best_c)) {
        best_v = ov;
        best_c = oc;
      }
    }
    if (tx == 0 && i < nf) {
      const long long o = static_cast<long long>(i) * (nt / kChunk) + chunk;
      vals[o] = best_v;
      cols[o] = best_c;
    }
  }
}

}  // namespace

extern "C" {

// Launch K2 on `stream` for one [nf, nt] tile -> [nf, nt/128] (value,
// in-tile column) candidates.  `val_f` / `val_t` are bytes (0 or 1).
// Returns the CUDA error of the launch (0 on success), or -1 when nt is
// not a multiple of 128.
int ldw_fused_tile_stage1(const void* codes, long long ld, long long fs,
                          long long ts, int nf, int nt, int S,
                          const void* wparts, const void* px, const void* py,
                          const void* pos_f, const void* pos_t,
                          const void* val_f, const void* val_t, float neff,
                          int same, int g, float half_g, float sr_dist,
                          void* vals, void* cols, void* stream) {
  if (nt % kChunk != 0 || nf <= 0 || nt <= 0) return -1;
  const dim3 grid(nt / kChunk, (nf + kTileRows - 1) / kTileRows);
  const dim3 block(kThreadsX, kThreadsY);
  fused_tile_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), ld, fs, ts, nf, nt, S,
      static_cast<const uint16_t*>(wparts), static_cast<const float*>(px),
      static_cast<const float*>(py), static_cast<const int*>(pos_f),
      static_cast<const int*>(pos_t), static_cast<const uint8_t*>(val_f),
      static_cast<const uint8_t*>(val_t), neff, same, g, half_g, sr_dist,
      static_cast<float*>(vals), static_cast<int*>(cols));
  return static_cast<int>(cudaGetLastError());
}

const char* ldw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
