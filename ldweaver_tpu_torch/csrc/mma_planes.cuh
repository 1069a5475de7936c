// Weighted one-hot count planes on Hopper's tensor cores (sm_90a): the
// contraction that the port's MI tile kernels share.
//
// For one block's BM x BN output tile (rows i = SNP columns fs+row0+i,
// columns j = SNP columns ts+col0+j of the sequence-major [S, ld] u8 code
// tensor) and every plane (x, y) with x < NX, y < NY:
//
//   c[x][y][i][j] = sum_t sum_s wparts[t][s] * 1[code(s, i) == x]
//                                            * 1[code(s, j) == y]
//
// over the genomes s < S and the first n_terms (1 to 3) bf16 weight terms
// t.  It is a GEMM with rows (x, i), columns (y, j) and depth (t, s),
// computed on
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation.  Every operand
// value is exact in bf16 (a weight term or 0 on the A side, 1 or 0 on the B
// side), so only the f32 sums round.
//
// One 256-thread block (8 warps, 2 along rows x 4 along columns) walks the
// genomes in chunks of kChunk = 64:
//   1. cp.async copies the chunk's raw u8 codes of the block's rows and
//      columns and its n_terms weight terms into shared memory (two stages:
//      chunk c+1 is in flight while chunk c is expanded and multiplied).
//      The 16-byte copies need 16-byte aligned rows; otherwise (`vec` is
//      false) the same stage is filled by plain loads.  Genomes past S and
//      SNPs past nf / nt read as code 0 with weight 0: genomes past S add 0,
//      rows and columns past the tile hold values nobody reads.
//   2. The block expands the chunk once into operand tiles, K-contiguous
//      rows padded to kRow = 72 halves (144 bytes, so the 8 row addresses
//      of one ldmatrix phase fall in 8 distinct 16-byte bank groups):
//        a[x][m][k] = 0xFFFF if code(k, m) == x else 0   (a bit mask),
//        b[y][n][k] = bf16 1.0 if code(k, n) == y else 0.
//   3. Each warp owns a WM x WN sub-tile with all NX*NY planes.  Per
//      k-step it loads each B fragment once (one ldmatrix.x4 gives two n8
//      fragments) and each A mask fragment once per (m16, x), and forms
//      the weighted A operand of term t in registers as mask & (w_t pair):
//      one AND per register, no weighted tile in shared memory.  The
//      products accumulate straight into the f32 counts, at most 64
//      registers a thread.  The term count is a template parameter of this
//      mainloop, unrolled whole: `run` picks one of three (1, 2 or 3
//      terms) once a chunk by the runtime n_terms, the same for the whole
//      grid, so the three-term loop is the code it was before the count
//      (a runtime guard inside the unrolled loop ran 3-13% slower at three
//      terms on an H100).  Fewer terms skip their products, not the
//      expansion of steps 1-2, which every term shares.
//   4. The counts go to shared memory over the spent operand tiles, as
//      float [NX][NY][BM][LDC], where an epilogue reads them (`count`)
//      with any thread mapping and few live registers.
// The kernel fits in 128 registers a thread without spilling, so two
// blocks share an SM and one block's expansion, barriers and epilogue run
// beside the other's products.
//
// mma.sync, not wgmma: its per-thread fragment layouts are fixed by the PTX
// ISA and need no shared-memory descriptor or swizzle contract.  It cannot
// reach the full rate of wgmma; a wgmma mainloop can replace `Planes::run`
// here in one place.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_planes {

constexpr int kWarpsM = 2, kWarpsN = 4;  // warps along rows x along columns
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
// blocks an SM at 128 registers a thread
constexpr int kBlocksPerSM = 65536 / (128 * kThreads);
constexpr int kChunk = 64;  // genomes per chunk (m16n8k16 k-steps of 16)
constexpr int kSteps = kChunk / 16;
constexpr int kTerms = 3;   // bf16 weight terms at most
constexpr int kRow = kChunk + 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy of the first `bytes` (0..16) source bytes; the rest
// of the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NX, int NY>
struct Planes {
  // Warp tile: NF n8 fragments (the B fragments of a k-step, 2 * NF * NY
  // registers, at most 8) and MF m16 fragments, so that a thread holds at
  // most 64 f32 counts (4 * MF * NF * NX * NY) and fits in 128 registers:
  // two blocks an SM, one's expansion and epilogue beside the other's
  // products.
  static constexpr int NF = NY == 1 ? 4 : NY == 2 ? 2 : 1;
  static constexpr int MF_ = 16 / (NF * NX * NY);
  static constexpr int MF = MF_ > 4 ? 4 : MF_ < 1 ? 1 : MF_;
  static constexpr int WM = 16 * MF, WN = 8 * NF;
  static constexpr int BM = kWarpsM * WM;  // block tile
  static constexpr int BN = kWarpsN * WN;
  static_assert(BM % 16 == 0 && BN % 16 == 0, "16-byte code segments");
  static_assert(NF == 1 || NF % 2 == 0, "B fragments load in pairs");

  struct Smem {
    alignas(16) uint8_t raw_f[2][kChunk][BM];
    alignas(16) uint8_t raw_t[2][kChunk][BN];
    alignas(16) uint16_t raw_w[2][kTerms][kChunk];
    alignas(16) uint16_t a[NX][BM][kRow];
    alignas(16) uint16_t b[NY][BN][kRow];
  };
  // the counts left by `run`: float [NX][NY][BM][LDC], over the operands
  static constexpr int LDC = BN + 4;
  static constexpr int kCountBytes = 4 * NX * NY * BM * LDC;
  static constexpr int kSmemBytes =
      sizeof(Smem) > kCountBytes ? sizeof(Smem) : kCountBytes;
  // dynamic shared memory: kBlocksPerSM blocks must fit in an SM's 227 KB
  static_assert(kSmemBytes <= 100 * 1024, "shared memory a block");

  using Acc = float[MF][NF][NX][NY][4];

  // count plane (x, y) at row li, column lj of the block tile, after `run`
  __device__ static float count(const void* smem, int x, int y, int li,
                                int lj) {
    return static_cast<const float*>(smem)[((x * NY + y) * BM + li) * LDC + lj];
  }

  // where a thread's mma C fragments sit in the block tile: fragment
  // (mi, ni) holds rows lane/4 and lane/4 + 8 (h = 0, 1) and columns
  // 2*(lane%4) + e (e = 0, 1) of the warp's m16 x n8 sub-tile (mi, ni)
  __device__ static int row(int warp, int lane, int mi, int h) {
    return (warp / kWarpsN) * WM + 16 * mi + lane / 4 + 8 * h;
  }
  __device__ static int col(int warp, int lane, int ni, int e) {
    return (warp % kWarpsN) * WN + 8 * ni + 2 * (lane % 4) + e;
  }

  // Stage the raw codes and the n_terms weight rows of genomes
  // s0..s0+kChunk (the rows past n_terms stay unwritten and unread).
  __device__ static void load(Smem& sm, int st, const uint8_t* codes,
                              long long ld, long long f0, long long t0,
                              int nf_left, int nt_left, int S,
                              const uint16_t* wparts, int n_terms, int s0,
                              bool vec) {
    const int tid = threadIdx.x;
    if (vec) {
      constexpr int SF = BM / 16, ST = BN / 16, SW = kChunk / 8;
      const int NSEG = kChunk * (SF + ST) + n_terms * SW;
      // not unrolled: the unrolled address arithmetic is chunk-invariant,
      // and hoisted out of the chunk loop it would take the registers the
      // counts need
#pragma unroll 1
      for (int k = tid; k < NSEG; k += kThreads) {
        const void* src = codes;
        void* dst;
        int bytes = 0;
        if (k < kChunk * (SF + ST)) {
          const int s = k / (SF + ST), q = k % (SF + ST);
          const bool is_f = q < SF;
          const int c = 16 * (is_f ? q : q - SF);
          const int left = (is_f ? nf_left : nt_left) - c;
          if (s0 + s < S && left > 0) {
            bytes = left < 16 ? left : 16;
            src = codes + (long long)(s0 + s) * ld + (is_f ? f0 : t0) + c;
          }
          dst = is_f ? (void*)&sm.raw_f[st][s][c] : (void*)&sm.raw_t[st][s][c];
        } else {
          const int t = (k - kChunk * (SF + ST)) / SW;
          const int s = 8 * ((k - kChunk * (SF + ST)) % SW);
          const int left = S - (s0 + s);
          if (left > 0) {
            bytes = 2 * (left < 8 ? left : 8);
            src = wparts + (long long)t * S + s0 + s;
          }
          dst = &sm.raw_w[st][t][s];
        }
        cp_async16(dst, src, bytes);
      }
      cp_async_commit();
    } else {
#pragma unroll 1
      for (int k = tid; k < kChunk * (BM + BN); k += kThreads) {
        const int s = k / (BM + BN), c = k % (BM + BN);
        const bool is_f = c < BM;
        const int cc = is_f ? c : c - BM;
        uint8_t v = 0;
        if (s0 + s < S && cc < (is_f ? nf_left : nt_left))
          v = codes[(long long)(s0 + s) * ld + (is_f ? f0 : t0) + cc];
        if (is_f)
          sm.raw_f[st][s][cc] = v;
        else
          sm.raw_t[st][s][cc] = v;
      }
#pragma unroll 1
      for (int k = tid; k < n_terms * kChunk; k += kThreads) {
        const int t = k / kChunk, s = k % kChunk;
        sm.raw_w[st][t][s] =
            s0 + s < S ? wparts[(long long)t * S + s0 + s] : uint16_t(0);
      }
    }
  }

  // One operand tile side: 8 genomes of one row m -> one 16-byte store a
  // plane, value `one` (the mask or bf16 1.0) where the code matches.
  template <int NR, int W>
  __device__ static void expand_side(const uint8_t (&raw)[kChunk][W],
                                     uint16_t (&op)[NR][W][kRow],
                                     uint32_t one) {
#pragma unroll 1  // as in `load`
    for (int k = threadIdx.x; k < W * (kChunk / 8); k += kThreads) {
      const int m = k % W, k8 = 8 * (k / W);
      uint8_t c[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) c[q] = raw[k8 + q][m];
#pragma unroll
      for (int x = 0; x < NR; ++x) {
        uint4 v;
        uint32_t* p = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[q] = (c[2 * q] == x ? one : 0u) |
                 (c[2 * q + 1] == x ? one << 16 : 0u);
        *reinterpret_cast<uint4*>(&op[x][m][k8]) = v;
      }
    }
  }

  // Multiply one expanded chunk into acc, one k-step at a time, over the
  // first T weight terms.
  template <int T>
  __device__ static void multiply(const Smem& sm, int st, Acc& acc, int warp,
                                  int lane) {
    const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
    // this thread's weight pairs sit at columns 2q and 2q + 8 of a k-step
    const uint32_t* ws =
        reinterpret_cast<const uint32_t*>(sm.raw_w[st]) + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      // B fragments of the k-step: one ldmatrix.x4 gives two n8 fragments
      const int kb = 16 * ks + 8 * ((lane >> 3) & 1);
      uint32_t b[NY][NF][2];
#pragma unroll
      for (int y = 0; y < NY; ++y) {
        if constexpr (NF == 1) {
          ldmatrix_x2(b[y][0], &sm.b[y][wn0 + (lane & 7)][kb]);
        } else {
#pragma unroll
          for (int q = 0; q < NF / 2; ++q) {
            uint32_t r[4];
            ldmatrix_x4(r, &sm.b[y][wn0 + 16 * q + (lane & 7) + 8 * (lane >> 4)][kb]);
            b[y][2 * q][0] = r[0];
            b[y][2 * q][1] = r[1];
            b[y][2 * q + 1][0] = r[2];
            b[y][2 * q + 1][1] = r[3];
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          uint32_t a[4];
          ldmatrix_x4(a, &sm.a[x][wm0 + 16 * mi + (lane & 15)]
                               [16 * ks + (lane >> 4) * 8]);
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const uint32_t lo = ws[t * (kChunk / 2) + 8 * ks];
            const uint32_t hi = ws[t * (kChunk / 2) + 8 * ks + 4];
            const uint32_t aw[4] = {a[0] & lo, a[1] & lo, a[2] & hi, a[3] & hi};
#pragma unroll
            for (int ni = 0; ni < NF; ++ni)
#pragma unroll
              for (int y = 0; y < NY; ++y)
                mma_bf16(acc[mi][ni][x][y], aw, b[y][ni][0], b[y][ni][1]);
          }
        }
    }
  }

  // The whole contraction of one block over the n_terms (1 to 3) rows of
  // `wparts` [n_terms, S]: the NX x NY count planes of rows
  // row0.. and columns col0.. of the tile, left in `smem` (kSmemBytes of
  // dynamic shared memory) for `count`.  Called by every thread of the
  // block; shared-memory writes made before the call are visible after
  // its first barrier, and the counts are visible when it returns.
  __device__ static void run(void* smem, const uint8_t* codes, long long ld,
                             long long fs, long long ts, int row0, int col0,
                             int nf, int nt, int S, const uint16_t* wparts,
                             int n_terms, bool vec) {
    Smem& sm = *static_cast<Smem*>(smem);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    Acc acc;
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
#pragma unroll
        for (int x = 0; x < NX; ++x)
#pragma unroll
          for (int y = 0; y < NY; ++y)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][x][y][e] = 0.f;
    const long long f0 = fs + row0, t0 = ts + col0;
    const int nf_left = nf - row0, nt_left = nt - col0;
    const int nchunks = (S + kChunk - 1) / kChunk;
    if (nchunks > 0)
      load(sm, 0, codes, ld, f0, t0, nf_left, nt_left, S, wparts, n_terms, 0,
           vec);
    for (int c = 0; c < nchunks; ++c) {
      const int st = c & 1;
      cp_async_wait_all();
      // chunk c is in place, and every warp is done with chunk c-1
      __syncthreads();
      if (c + 1 < nchunks)
        load(sm, st ^ 1, codes, ld, f0, t0, nf_left, nt_left, S, wparts,
             n_terms, (c + 1) * kChunk, vec);
      expand_side<NX, BM>(sm.raw_f[st], sm.a, 0xFFFFu);
      expand_side<NY, BN>(sm.raw_t[st], sm.b, 0x3F80u);
      __syncthreads();
      if (n_terms == 1)
        multiply<1>(sm, st, acc, warp, lane);
      else if (n_terms == 2)
        multiply<2>(sm, st, acc, warp, lane);
      else
        multiply<kTerms>(sm, st, acc, warp, lane);
    }
    // every warp is done with the operands: the counts take their place
    __syncthreads();
    float* counts = static_cast<float*>(smem);
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
#pragma unroll
        for (int x = 0; x < NX; ++x)
#pragma unroll
          for (int y = 0; y < NY; ++y)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(
                  &counts[((x * NY + y) * BM + row(warp, lane, mi, h)) * LDC +
                          col(warp, lane, ni, 0)]) =
                  make_float2(acc[mi][ni][x][y][2 * h],
                              acc[mi][ni][x][y][2 * h + 1]);
    __syncthreads();
  }
};

// True when every 16-byte segment `Planes::load` copies is 16-byte aligned.
inline bool vec_ok(const void* codes, long long ld, long long fs, long long ts,
                   const void* wparts, int S) {
  return reinterpret_cast<uintptr_t>(codes) % 16 == 0 && ld % 16 == 0 &&
         fs % 16 == 0 && ts % 16 == 0 &&
         reinterpret_cast<uintptr_t>(wparts) % 16 == 0 && S % 8 == 0;
}

}  // namespace mma_planes
