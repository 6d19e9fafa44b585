// The moment sweep of one (i-tile, j-block) pair, shared by
// fused_moments.cu and both modes of align_fused.cu:
//
//   part[k, j] = sum_{i in tile} A_ij Phi[i, k]    (35 monomials, 128 j)
//   count      = #{(i, j) in tile : A_ij > 0}
//
// Replaces the contraction of the JAX package's TPU kernels: the moment
// sweep of ops/pallas_moments.py:fused_moments (:128-133) and of both
// kernels of ops/pallas_align.py:align_fused (resident :556-559, tiled
// :897-900), which ran A^T Phi on the MXU at Precision.HIGHEST.
//
// Bound on the H100: a kept tile is 64 x 128 pairs; each costs ~35 fp32
// operations for its weight (d2, the accurate exp, the gate; 44 more
// for a recomputed color kernel) and 70 for its share of the
// contraction, and the sweep of a whole align iteration needs ~1 us of
// the card's fp32 rate.  What the card spent was latency: a chunk of
// kept tiles walked in series by one block while the others had already
// left, and a second pass over every chunk partial.  The work split is
// what changes: one (i-tile, j-block) pair is one work item, the callers
// spread the kept tiles over the blocks, and a column sums only the kept
// tiles' partials.
//
// The contraction stays on the CUDA cores: a thread owns one j, keeps
// its 35 moments in registers and walks the tile's 64 rows in order, one
// fused multiply-add a moment where the weight is not zero, with the
// weights' arithmetic of pair_tile.cuh (the caller's functor).  A tile's
// partial is then the bits of the kernel it replaces, which summed the
// same rows in the same order.  Two tensor-core forms were built and
// measured first (PERF.md §6): 3xTF32 mma (cvt.rna hi/lo, three tf32
// products, each 8-row step summed from zero) and float64 mma
// (m8n8k4.f64, each step's exact products summed in float64 and rounded
// once).  Both held every column within 2e-7 of its magnitude and ran a
// kept tile in ~13 us against ~20, but the align loop amplifies any
// change in the sums: 3xTF32 left the tiled 3072 pair 3.1e-4 in omega
// from the float32 plain version after 10 iterations (the gate is 1e-4),
// and float64 moved a C++-stop align from the float32 CPU's 164
// iterations to 186 (the skew gate is 10%) and an acvo card-vs-CPU
// align past 3e-4.
//
// The tile's Phi rows, x, mask and features are copied with cp.async
// while the block stages its own j.  No float atomics: an item writes
// its own partial slot, and the caller sums the slots of a column in
// i-tile order (column_sum).
#pragma once

#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace cvo {
namespace mt {

constexpr int TI = 64;    // i per tile; ops/moments.py TILE_I
constexpr int TJ = 128;   // j per tile, one a thread; ops/moments.py TILE_J
constexpr int NT = TJ;    // threads
constexpr int NW = NT / 32;
constexpr int NMOM = 35;  // monomials of degree <= 4 in 3 variables

// One staged i-tile.
struct Tile {
  float phi[TI * NMOM];   // Phi rows
  float4 x[TI];           // x0, x1, x2, mask
  float f[TI][NFEAT];
};

// The item's TJ moving points, one a thread.
struct Cols {
  float y[3][TJ];
  float f[TJ][NFEAT];
  float m[TJ];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Start the copies of the i-tile at row i0: Phi rows, x, the mask and,
// when `feat`, the features.  Every thread of the block calls it; the
// tile may be read only after stage_end.
__device__ __forceinline__ void stage_begin(Tile& T, const float* xp,
                                            const float* xf, const float* xm,
                                            const float* phi, int i0,
                                            bool feat) {
  // 64 rows of 35 floats are 560 16-byte pieces (phi is 16-byte
  // aligned: the wrappers check it or allocate it)
  const float* src = phi + static_cast<size_t>(i0) * NMOM;
  for (int t = threadIdx.x; t < TI * NMOM / 4; t += NT)
    cp_async16(T.phi + 4 * t, src + 4 * t);
  for (int t = threadIdx.x; t < TI * 3; t += NT)
    cp_async4(reinterpret_cast<float*>(&T.x[t / 3]) + t % 3, xp + 3 * i0 + t);
  for (int t = threadIdx.x; t < TI; t += NT)
    cp_async4(reinterpret_cast<float*>(&T.x[t]) + 3, xm + i0 + t);
  if (feat)
    for (int t = threadIdx.x; t < TI * NFEAT; t += NT)
      cp_async4(&T.f[0][0] + t, xf + NFEAT * i0 + t);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for the tile's copies.
__device__ __forceinline__ void stage_end() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// The sweep of a staged tile for the thread's j: acc[k] += A_ij Phi[i, k]
// over the tile's rows in order, one fused multiply-add each, where the
// weight is not zero; returns the count of A > 0.  weight(ii, xi, fi) is
// A of the thread's j and tile row ii, whose x and mask are xi and
// features fi (shared memory).
template <class Weight>
__device__ __forceinline__ int sweep(const Tile& T, const Weight& weight,
                                     float (&acc)[NMOM]) {
  int cnt = 0;
  for (int ii = 0; ii < TI; ++ii) {
    const float w = weight(ii, T.x[ii], T.f[ii]);
    // a linear weight may be negative: it enters the moments, and only
    // w > 0 is counted
    if (w != 0.0f) {
      cnt += w > 0.0f;
#pragma unroll
      for (int k = 0; k < NMOM; ++k)
        acc[k] = fmaf(w, T.phi[ii * NMOM + k], acc[k]);
    }
  }
  return cnt;
}

// part[k * m + j0 + j] = acc: consecutive threads, consecutive j.
__device__ __forceinline__ void store(const float (&acc)[NMOM], float* part,
                                      size_t m, int j0) {
#pragma unroll
  for (int k = 0; k < NMOM; ++k) part[k * m + j0 + threadIdx.x] = acc[k];
}

// Shared memory of column_sum.
struct ColumnScratch {
  int list[NT];     // kept i-tiles of a window of NT, in order
  int warp[NW];
  int n;
};

// sum[k - k0] += part[c, k, j] for KN columns k from k0, over the
// i-tiles c < nbi that kept(c) keeps
// (a skipped tile's partial is zero and unwritten), in i-tile order:
// the same bits as summing every tile's partial, the skipped ones zero.
// part [nbi, 35, m] was written by other blocks: read at L2.  The rule
// is evaluated side by side and the kept tiles compacted first, so the
// partial loads of a tile do not wait on one another.  Every thread of
// the block calls it; kept(c) is the same in every thread.
template <int KN, class Kept>
__device__ __forceinline__ void column_sum(const float* part, int nbi,
                                           size_t m, int j, int k0,
                                           const Kept& kept, ColumnScratch& cs,
                                           float (&sum)[KN]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < nbi; c0 += NT) {
    const int c = c0 + threadIdx.x;
    const bool keep = c < nbi && kept(c);
    const unsigned bits = __ballot_sync(0xffffffffu, keep);
    __syncthreads();  // the last window's list is consumed
    if (lane == 0) cs.warp[warp] = __popc(bits);
    __syncthreads();
    int at = __popc(bits & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += cs.warp[w];
    if (keep) cs.list[at] = c;
    if (threadIdx.x == 0) {
      int n = 0;
      for (int w = 0; w < NW; ++w) n += cs.warp[w];
      cs.n = n;
    }
    __syncthreads();
    const int n = cs.n;
    for (int q = 0; q < n; ++q) {
      const float* p =
          part + (static_cast<size_t>(cs.list[q]) * NMOM + k0) * m + j;
#pragma unroll
      for (int k = 0; k < KN; ++k) sum[k] += __ldcg(p + k * m);
    }
  }
}

}  // namespace mt
}  // namespace cvo
