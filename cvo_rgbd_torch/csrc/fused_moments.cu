// fused_moments: one sweep of the gated Gram per align iteration.
//
// Replaces the JAX package's ops/pallas_moments.py:fused_moments
// (_moments_body, A tile from pallas_gram.py:_pair_tile):
//   Mom[j, k] = sum_i A_ij * Phi[i, k]   (35 monomials of x_i - c0)
//   nnz       = #{(i, j) : A_ij > 0}
// with A_ij gated on d2 < d2_thres, a > sp_thres and the masks, and an
// exact AABB skip of (i-tile, j-block) pairs whose lower bound on d2
// exceeds d2_thres + SKIP_MARGIN (such tiles hold only zeros).
//
// Bound on the H100: per unskipped pair ~35 fp32 operations (d2, exp,
// gate) plus 70 (35 FMAs) where the pair passes the gate, and 4 bytes
// of ck when the color kernel is cached.  The TPU kernel did the A^T Phi
// contraction on the MXU; here it is scalar FMAs, because A is sparse
// (most gated pairs are zero) and the moment block stays in registers:
//   - a block owns TJ consecutive j, one per thread, and keeps that j's
//     35 moments in registers for the whole sweep;
//   - it walks TI-row i-tiles staged in shared memory (x planes, Phi
//     rows, masks, features), so every Phi value a warp needs is one
//     broadcast read; the ck row slice is read straight from global
//     memory, coalesced (consecutive threads, consecutive j);
//   - a skipped tile costs one bound compare for the whole block;
//   - the i range is split into S chunks to fill the SMs; each chunk
//     writes its own partial moments and an int nnz, and a second small
//     kernel sums the S partials in a fixed order.  No float atomics:
//     the sums, and through the gates the iteration counts, are the
//     same from run to run.
#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace {

constexpr int TJ = 128;   // j per block (one per thread); must match ops/moments.py
constexpr int TI = 64;    // i per shared-memory tile; must match ops/moments.py
constexpr int NMOM = 35;  // monomials of degree <= 4 in 3 variables
constexpr float SKIP_MARGIN = 1e-5f;

template <bool USE_CK>
__global__ void __launch_bounds__(TJ)
moments_partial_kernel(const float* __restrict__ xp,
                       const float* __restrict__ xf,
                       const float* __restrict__ xm,
                       const float* __restrict__ yp,
                       const float* __restrict__ yf,
                       const float* __restrict__ ym,
                       const float* __restrict__ phi,
                       const float* __restrict__ ck,
                       const float* __restrict__ md,
                       const float* __restrict__ scal,
                       float* __restrict__ part, int* __restrict__ nnz_part,
                       int n, int m, int tiles_per_chunk) {
  __shared__ float s_phi[TI][NMOM];
  __shared__ float s_x[3][TI];
  __shared__ float s_f[USE_CK ? 1 : TI][cvo::NFEAT];
  __shared__ float s_m[TI];
  __shared__ int s_cnt[TJ / 32];

  const int jb = blockIdx.x;
  const int chunk = blockIdx.y;
  const int nbi = n / TI;
  const int nbj = m / TJ;
  const int j = jb * TJ + threadIdx.x;

  const float y0 = yp[3 * j], y1 = yp[3 * j + 1], y2 = yp[3 * j + 2];
  float fy[cvo::NFEAT];
  float ymj = 0.0f;
  if constexpr (!USE_CK) {
#pragma unroll
    for (int c = 0; c < cvo::NFEAT; ++c) fy[c] = yf[cvo::NFEAT * j + c];
    ymj = ym[j];
  }
  const float skip_thres = scal[cvo::S_D2_THRES] + SKIP_MARGIN;

  float acc[NMOM];
#pragma unroll
  for (int k = 0; k < NMOM; ++k) acc[k] = 0.0f;
  int cnt = 0;

  const int ib0 = chunk * tiles_per_chunk;
  const int ib1 = min(nbi, ib0 + tiles_per_chunk);
  for (int ib = ib0; ib < ib1; ++ib) {
    // block-uniform: every thread takes the same branch
    if (md != nullptr && md[ib * nbj + jb] > skip_thres) continue;
    __syncthreads();  // the previous tile is consumed
    const int i0 = ib * TI;
    for (int t = threadIdx.x; t < TI * NMOM; t += TJ)
      s_phi[t / NMOM][t % NMOM] = phi[static_cast<size_t>(i0) * NMOM + t];
    for (int t = threadIdx.x; t < TI * 3; t += TJ)
      s_x[t % 3][t / 3] = xp[3 * i0 + t];
    if constexpr (!USE_CK) {
      for (int t = threadIdx.x; t < TI * cvo::NFEAT; t += TJ)
        s_f[t / cvo::NFEAT][t % cvo::NFEAT] = xf[cvo::NFEAT * i0 + t];
      for (int t = threadIdx.x; t < TI; t += TJ) s_m[t] = xm[i0 + t];
    }
    __syncthreads();

    for (int ii = 0; ii < TI; ++ii) {
      const float d2 =
          cvo::sqdist3(s_x[0][ii], s_x[1][ii], s_x[2][ii], y0, y1, y2);
      float a;
      if constexpr (USE_CK) {
        a = cvo::pair_cached(d2, ck[static_cast<size_t>(i0 + ii) * m + j],
                             scal);
      } else {
        a = cvo::pair_full(d2, s_f[ii], s_m[ii], fy, ymj, scal);
      }
      if (a > 0.0f) {
        ++cnt;
#pragma unroll
        for (int k = 0; k < NMOM; ++k) acc[k] = fmaf(a, s_phi[ii][k], acc[k]);
      }
    }
  }

  // partials [S, NMOM, M]: consecutive threads write consecutive j
#pragma unroll
  for (int k = 0; k < NMOM; ++k)
    part[(static_cast<size_t>(chunk) * NMOM + k) * m + j] = acc[k];

  // integer block count: exact in any order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < TJ / 32; ++w) tot += s_cnt[w];
    nnz_part[chunk * nbj + jb] = tot;
  }
}

// Mom[j, k] = sum over chunks in order 0..S-1; nnz = sum of the counts.
__global__ void moments_reduce_kernel(const float* __restrict__ part,
                                      const int* __restrict__ nnz_part,
                                      float* __restrict__ mom,
                                      float* __restrict__ nnz, int m,
                                      int n_chunks, int n_counts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // k * m + j
  if (t < NMOM * m) {
    const int k = t / m;
    const int j = t - k * m;
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c)
      s += part[(static_cast<size_t>(c) * NMOM + k) * m + j];
    mom[static_cast<size_t>(j) * NMOM + k] = s;
  }
  if (t == 0) {
    long long tot = 0;
    for (int c = 0; c < n_counts; ++c) tot += nnz_part[c];
    nnz[0] = static_cast<float>(tot);
  }
}

}  // namespace

// part: [n_chunks, 35, m] f32 scratch; nnz_part: [n_chunks, m / TJ] i32
// scratch; mom: [m, 35] f32; nnz: [1] f32.  ck or md may be null.
extern "C" int fused_moments_launch(
    const float* xp, const float* xf, const float* xm, const float* yp,
    const float* yf, const float* ym, const float* phi, const float* ck,
    const float* md, const float* scal, float* part, int* nnz_part,
    float* mom, float* nnz, int n, int m, int tiles_per_chunk, int n_chunks,
    cudaStream_t stream) {
  const dim3 grid(m / TJ, n_chunks);
  if (ck != nullptr) {
    moments_partial_kernel<true><<<grid, TJ, 0, stream>>>(
        xp, xf, xm, yp, yf, ym, phi, ck, md, scal, part, nnz_part, n, m,
        tiles_per_chunk);
  } else {
    moments_partial_kernel<false><<<grid, TJ, 0, stream>>>(
        xp, xf, xm, yp, yf, ym, phi, ck, md, scal, part, nnz_part, n, m,
        tiles_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = NMOM * m;
  const int threads = 256;
  moments_reduce_kernel<<<(total + threads - 1) / threads, threads, 0,
                          stream>>>(part, nnz_part, mom, nnz, m, n_chunks,
                                    n_chunks * (m / TJ));
  return static_cast<int>(cudaGetLastError());
}
