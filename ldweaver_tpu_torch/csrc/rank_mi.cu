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
// Two forms, chosen at compile time (STAGE1):
//   * the store form writes the [nf, nt] f32 tile (BLK5, the spmd sweep,
//     the host-facing tiles, and LR tiles of at most 1024 columns);
//   * the LR stage-1 form is K2's epilogue on K1's tile, for the LR
//     sweep's non-(2, 2, pure) tiles wider than 1024 columns: each cell's
//     MI, bit for bit the store form's value (one `cell_mi` serves both),
//     goes through the LR mask (tri = (i > j) | !same, validity of both
//     sites, f32 circular length 0.5g - |d - 0.5g| with the branchless
//     d = diff + (diff < 0) * g above sr_dist, else -inf), and every
//     128-column chunk is reduced to its max and the FIRST in-tile column
//     attaining it; an all -inf chunk reports its first column.  Only the
//     [nf, nt/128] (value, column) pairs reach device memory.
// A block of the stage-1 form owns one 128-column chunk of its BM rows
// whole, so the result does not depend on the order in which blocks run.
// The block tile is BN = 32 to 128 columns wide (the more planes, the
// narrower), so the block walks the chunk in 128 / BN column sub-tiles,
// one contraction each, left to right.  In a sub-tile each warp takes
// BM / 8 rows; lane l scans columns l, l + 32, ... in ascending order with
// a strict '>' (the first maximum), a 5-step shuffle reduction whose tie
// rule takes the smaller column finishes the row, and lane 0 keeps the
// row's running (max, column) in shared memory, replaced only by a
// strictly larger max of a later sub-tile (whose columns all lie to the
// right).  So the chunk's first maximum wins across sub-tiles too.
//
// What bounds it on an H100 SXM (B = 4096): the contraction,
// 2 * B^2 * n_terms * S per plane at 989 TFLOP/s: at three terms 62.7 us
// a plane at S = 616 and 104.2 us at S = 1024 (the LR sweep's (2,3)
// buckets: 0.2085 ms), a third of that at one term; writing the 64 MB f32
// tile takes 20 us at 3.35 TB/s.  So every counted bucket is bound by
// operations.  The stage-1 form does the same contraction and stores 1 MB
// of candidates in place of the 64 MB tile; the mask and the chunk max it
// adds were, as torch ops over the stored tile, ~15 passes over its
// 16.8 M cells (~1.9 GB a tile).
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
#include <math.h>
#include <stdint.h>

#include "mma_planes.cuh"

namespace {

using mma_planes::kThreads;

constexpr int kChunk = 128;  // stage-1 chunk width

// The stage-1 form's mask inputs and outputs (the store form takes none):
// positions and validity (bytes 0 or 1) of the rows and columns, whether
// the tile is a diagonal block pair, the genome length, sr_dist, and the
// [nf, nt/128] candidates.
struct Stage1 {
  const int* pos_f;
  const int* pos_t;
  const uint8_t* val_f;
  const uint8_t* val_t;
  int same, g;
  float half_g, sr_dist;
  float* vals;
  int* cols;
};

template <int RF, int RT, bool PURE, bool STAGE1>
__global__ void __launch_bounds__(kThreads, mma_planes::kBlocksPerSM)
rank_mi_kernel(const uint8_t* __restrict__ codes, long long ld, long long fs,
               long long ts, int nf, int nt, int S,
               const uint16_t* __restrict__ wparts, int n_terms,
               const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ r_f, const float* __restrict__ r_t,
               float neff, float* __restrict__ out, bool vec,
               const Stage1 lr) {
  constexpr bool COUNT = RF >= 2 && RT >= 2;
  using P = mma_planes::Planes<COUNT ? RF - 1 : 1, COUNT ? RT - 1 : 1>;
  constexpr int BM = P::BM, BN = P::BN;
  // column sub-tiles a block walks: the stage-1 form covers a whole chunk
  constexpr int NSUB = STAGE1 ? kChunk / BN : 1;
  static_assert(kChunk % BN == 0, "a chunk is whole block tiles");
  constexpr int BM1 = STAGE1 ? BM : 1, BN1 = STAGE1 ? BN : 1;

  __shared__ float s_px[RF][BM];
  __shared__ float s_py[RT][BN];
  __shared__ float s_rf[BM];
  __shared__ float s_rt[BN];
  __shared__ float s_lx[BM];
  __shared__ float s_ly[BN];
  // the pure epilogue's den, log(den), 1 / den: read from here after the
  // contraction, so that no register holds them through it
  __shared__ float s_den[3];
  // stage 1: the rows' and columns' mask inputs, each row's running max
  __shared__ int s_posf[BM1];
  __shared__ uint8_t s_vf[BM1];
  __shared__ float s_best_v[BM1];
  __shared__ int s_best_c[BM1];
  __shared__ int s_post[BN1];
  __shared__ uint8_t s_vt[BN1];
  extern __shared__ uint4 planes_smem[];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;

  // marginals and allele counts of this tile's rows
  for (int k = tid; k < RF * BM; k += kThreads) {
    const int x = k / BM, c = k % BM;
    s_px[x][c] = row0 + c < nf ? px[(long long)x * nf + row0 + c] : 0.f;
  }
  for (int c = tid; c < BM; c += kThreads) {
    const bool in = row0 + c < nf;
    s_rf[c] = in ? r_f[row0 + c] : 0.f;
    if constexpr (STAGE1) {
      s_posf[c] = in ? lr.pos_f[row0 + c] : 0;
      s_vf[c] = in ? lr.val_f[row0 + c] : uint8_t(0);
    }
  }

  if (PURE && tid == 0) {
    const float den_s = neff + float(0.5 * RF * RT);
    s_den[0] = den_s;
    s_den[1] = logf(den_s);
    s_den[2] = 1.0f / den_s;
  }

  // The MI of cell (li, lj) of the block tile from the counts `run` left
  // in shared memory: one code for both forms, so that the stage-1 form
  // sees the values the store form writes, bit for bit.
  const auto cell_mi = [&](int li, int lj) -> float {
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
      // fast_sweep.py:223-240, every rounding spelt out: the compiler may
      // fuse a product into an add only where both sit in one block, which
      // the two forms' loops would decide differently for the tile-wide
      // den * log(den)
      float ent = 0.f;
#pragma unroll
      for (int x = 0; x < RF; ++x)
#pragma unroll
        for (int y = 0; y < RT; ++y) {
          const float p = cnt[x][y] + 0.5f;
          ent = __fmaf_rn(p, logf(p), ent);
        }
      mi = __fmul_rn(__fmaf_rn(s_den[0], s_den[1],
                               __fsub_rn(__fsub_rn(ent, s_lx[li]), s_ly[lj])),
                     s_den[2]);
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
    return mi;
  };

#pragma unroll 1
  for (int sub = 0; sub < NSUB; ++sub) {
    const int col0 = STAGE1 ? blockIdx.x * kChunk + sub * BN : blockIdx.x * BN;
    // every warp is done with the last sub-tile's counts and column terms
    if (sub > 0) __syncthreads();

    // marginals and allele counts of the columns
    for (int k = tid; k < RT * BN; k += kThreads) {
      const int y = k / BN, c = k % BN;
      s_py[y][c] = col0 + c < nt ? py[(long long)y * nt + col0 + c] : 0.f;
    }
    for (int c = tid; c < BN; c += kThreads) {
      s_rt[c] = col0 + c < nt ? r_t[col0 + c] : 0.f;
      if constexpr (STAGE1) {  // nt is a multiple of kChunk
        s_post[c] = lr.pos_t[col0 + c];
        s_vt[c] = lr.val_t[col0 + c];
      }
    }
    __syncthreads();

    if constexpr (PURE) {
      // row / column terms of the telescoped epilogue (fast_sweep.py:232-239)
      if (sub == 0) {
        for (int c = tid; c < BM; c += kThreads) {
          float lx = 0.f;
#pragma unroll
          for (int x = 0; x < RF; ++x) {
            const float p = s_px[x][c] + float(0.5 * RT);
            lx = __fmaf_rn(logf(p), p, lx);
          }
          s_lx[c] = lx;
        }
      }
      for (int c = tid; c < BN; c += kThreads) {
        float ly = 0.f;
#pragma unroll
        for (int y = 0; y < RT; ++y) {
          const float p = s_py[y][c] + float(0.5 * RF);
          ly = __fmaf_rn(logf(p), p, ly);
        }
        s_ly[c] = ly;
      }
    }

    __syncthreads();

    if constexpr (COUNT)
      P::run(planes_smem, codes, ld, fs, ts, row0, col0, nf, nt, S, wparts,
             n_terms, vec);

    if constexpr (!STAGE1) {
      // one output a thread at a time, neighbouring threads on neighbouring
      // columns
      for (int k = tid; k < BM * BN; k += kThreads) {
        const int li = k / BN, lj = k % BN;
        const int i = row0 + li, j = col0 + lj;
        if (i >= nf || j >= nt) continue;
        out[(long long)i * nt + j] = cell_mi(li, lj);
      }
    } else {
      // each warp BM / 8 whole rows of the sub-tile, lane l on columns
      // l, l + 32, ...
      constexpr int kRowsPerWarp = BM / (kThreads / 32);
      const int warp = tid / 32, lane = tid % 32;
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int li = warp * kRowsPerWarp + r;
        const int i = row0 + li;
        if (i >= nf) break;  // rows ascend; the same for the whole warp
        const int posf = s_posf[li];
        const bool vf = s_vf[li] != 0;
        float best_v = -INFINITY;
        int best_c = col0 + lane;
#pragma unroll
        for (int q = 0; q < BN / 32; ++q) {
          const int lj = lane + 32 * q;
          const int j = col0 + lj;
          const float mi = cell_mi(li, lj);
          // the LR mask, as K2's (fused_tile.cu) and fast_sweep.tile_masks
          const bool tri = (i > j) || lr.same == 0;
          const bool ok = tri && vf && s_vt[lj] != 0;
          const int diff = s_post[lj] - posf;
          const int d = diff + (diff < 0 ? lr.g : 0);
          const float lens =
              lr.half_g - fabsf(static_cast<float>(d) - lr.half_g);
          const float v = (ok && lens > lr.sr_dist) ? mi : -INFINITY;
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
        // across sub-tiles: a later one lies to the right, so it wins only
        // with a strictly larger max
        if (lane == 0) {
          if (sub == 0 || best_v > s_best_v[li]) {
            s_best_v[li] = best_v;
            s_best_c[li] = best_c;
          }
          if (sub == NSUB - 1) {
            const long long o =
                static_cast<long long>(i) * (nt / kChunk) + blockIdx.x;
            lr.vals[o] = s_best_v[li];
            lr.cols[o] = s_best_c[li];
          }
        }
      }
    }
  }
}

template <int RF, int RT, bool PURE, bool STAGE1>
int launch(const uint8_t* codes, long long ld, long long fs, long long ts,
           int nf, int nt, int S, const uint16_t* wparts, int n_terms,
           const float* px, const float* py, const float* r_f,
           const float* r_t, float neff, float* out, const Stage1& lr,
           cudaStream_t stream) {
  constexpr bool COUNT = RF >= 2 && RT >= 2;
  using P = mma_planes::Planes<COUNT ? RF - 1 : 1, COUNT ? RT - 1 : 1>;
  // the telescoped epilogue needs both sides polymorphic (fast_sweep.py:223)
  constexpr bool PU = PURE && COUNT;
  // the stage-1 form: one block a 128-column chunk of BM rows
  const dim3 grid(STAGE1 ? nt / kChunk : (nt + P::BN - 1) / P::BN,
                  (nf + P::BM - 1) / P::BM);
  const bool vec = mma_planes::vec_ok(codes, ld, fs, ts, wparts, S);
  const auto kernel = rank_mi_kernel<RF, RT, PU, STAGE1>;
  const int smem = COUNT ? P::kSmemBytes : 0;
  if (smem > 48 * 1024) {  // above 48 KB only with the opt-in attribute
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(codes, ld, fs, ts, nf, nt, S,
                                           wparts, n_terms, px, py, r_f, r_t,
                                           neff, out, vec, lr);
  return static_cast<int>(cudaGetLastError());
}

// Launch one form of K1 for the bucket (Rf, Rt, pure); -1 when (Rf, Rt) is
// outside 1..5 or n_terms outside 1..3.
template <bool STAGE1>
int dispatch(int Rf, int Rt, int pure, const void* codes, long long ld,
             long long fs, long long ts, int nf, int nt, int S,
             const void* wparts, int n_terms, const void* px, const void* py,
             const void* r_f, const void* r_t, float neff, void* out,
             const Stage1& lr, void* stream) {
  if (n_terms < 1 || n_terms > mma_planes::kTerms) return -1;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* w = static_cast<const uint16_t*>(wparts);
  const auto* pxp = static_cast<const float*>(px);
  const auto* pyp = static_cast<const float*>(py);
  const auto* rfp = static_cast<const float*>(r_f);
  const auto* rtp = static_cast<const float*>(r_t);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define LDW_CASE(A, B)                                                      \
  case (A) * 8 + (B):                                                       \
    return pure ? launch<A, B, true, STAGE1>(c, ld, fs, ts, nf, nt, S, w,   \
                                             n_terms, pxp, pyp, rfp, rtp,   \
                                             neff, o, lr, st)               \
                : launch<A, B, false, STAGE1>(c, ld, fs, ts, nf, nt, S, w,  \
                                              n_terms, pxp, pyp, rfp, rtp,  \
                                              neff, o, lr, st);
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

}  // namespace

extern "C" {

// Launch K1's store form on `stream` for one [nf, nt] tile over the
// n_terms rows of wparts [n_terms, S].  Returns the CUDA error of the
// launch (0 on success), or -1 when (Rf, Rt) is outside 1..5 or n_terms
// outside 1..3.
int ldw_rank_mi_tile(int Rf, int Rt, int pure, const void* codes,
                     long long ld, long long fs, long long ts, int nf, int nt,
                     int S, const void* wparts, int n_terms, const void* px,
                     const void* py, const void* r_f, const void* r_t,
                     float neff, void* out, void* stream) {
  return dispatch<false>(Rf, Rt, pure, codes, ld, fs, ts, nf, nt, S, wparts,
                         n_terms, px, py, r_f, r_t, neff, out, Stage1{},
                         stream);
}

// Launch K1's LR stage-1 form on `stream` for one [nf, nt] tile ->
// [nf, nt/128] (value, in-tile column) candidates.  `val_f` / `val_t` are
// bytes (0 or 1).  Returns the CUDA error of the launch (0 on success), or
// -1 when nt is not a positive multiple of 128, nf is not positive, (Rf,
// Rt) is outside 1..5 or n_terms outside 1..3.
int ldw_rank_mi_stage1(int Rf, int Rt, int pure, const void* codes,
                       long long ld, long long fs, long long ts, int nf,
                       int nt, int S, const void* wparts, int n_terms,
                       const void* px, const void* py, const void* r_f,
                       const void* r_t, float neff, const void* pos_f,
                       const void* pos_t, const void* val_f,
                       const void* val_t, int same, int g, float half_g,
                       float sr_dist, void* vals, void* cols, void* stream) {
  if (nt % kChunk != 0 || nf <= 0 || nt <= 0) return -1;
  const Stage1 lr{static_cast<const int*>(pos_f),
                  static_cast<const int*>(pos_t),
                  static_cast<const uint8_t*>(val_f),
                  static_cast<const uint8_t*>(val_t),
                  same,
                  g,
                  half_g,
                  sr_dist,
                  static_cast<float*>(vals),
                  static_cast<int*>(cols)};
  return dispatch<true>(Rf, Rt, pure, codes, ld, fs, ts, nf, nt, S, wparts,
                        n_terms, px, py, r_f, r_t, neff, nullptr, lr, stream);
}

const char* ldw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
