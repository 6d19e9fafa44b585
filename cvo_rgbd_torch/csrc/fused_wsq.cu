// fused_wsq: the lean self-kernel sweep of adaptive CVO.
//
// Replaces the JAX package's ops/pallas_moments.py:fused_wsq (_wsq_body,
// A tile from pallas_gram.py:_pair_tile):
//   wsq = sum_ij A_ij * d2_ij      nnz = #{(i, j) : A_ij > 0}
// the only two quantities the adaptive dl reduction needs from the
// self-kernels Axx / Ayy (adaptive_cvo.cpp:222-271).  A is gated exactly
// as in fused_moments.cu (pair_tile.cuh), with the same exact AABB skip
// of tiles whose lower bound on d2 exceeds d2_thres + SKIP_MARGIN.
//
// Bound on the H100: per unskipped pair ~37 fp32 operations (d2, exp,
// gate, the a*d2 FMA) and 4 bytes of ck when the color kernel is cached;
// the inputs are a few hundred KB.  At the converged length-scales most
// tiles skip, so the cost is the kept tiles' ck bytes and arithmetic.
// Design:
//   - square TW x TW tiles, so with `symmetric` (x and y the same cloud)
//     the (bj, bi) tile is the exact transpose of (bi, bj): only the upper
//     triangle bj >= bi is launched, one block per tile, off-diagonal
//     tiles weighted 2 (pallas_moments.py:270-275);
//   - a block stages the tile's TW x-rows in shared memory and gives each
//     thread one y column (kept in registers) and TW / ROWS_PER_PASS rows;
//     a warp reads one x row as a broadcast and 32 consecutive ck entries
//     of that row, coalesced;
//   - a skipped tile costs one block-uniform bound compare;
//   - each thread sums a*d2 in fp32 registers and counts gates as an int;
//     warp shuffles then shared memory reduce the block in a fixed order,
//     and the block writes one float and one int partial.  A second tiny
//     kernel sums the partials in a fixed order.  No float atomics: wsq,
//     and through dl the ell trajectory and the iteration counts, are the
//     same from run to run.
#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace {

constexpr int TW = 64;               // tile width; must match ops/wsq.py TILE_W
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / TW;  // 4 row groups
constexpr int WARPS = THREADS / 32;
constexpr int RED_THREADS = 256;
constexpr float SKIP_MARGIN = 1e-5f;

template <bool USE_CK>
__global__ void __launch_bounds__(THREADS)
wsq_partial_kernel(const float* __restrict__ xp, const float* __restrict__ xf,
                   const float* __restrict__ xm, const float* __restrict__ yp,
                   const float* __restrict__ yf, const float* __restrict__ ym,
                   const float* __restrict__ ck, const float* __restrict__ md,
                   const float* __restrict__ scal,
                   float* __restrict__ wsq_part, int* __restrict__ cnt_part,
                   int n, int m, int symmetric) {
  __shared__ float s_x[3][TW];
  __shared__ float s_f[USE_CK ? 1 : TW][cvo::NFEAT];
  __shared__ float s_m[TW];
  __shared__ float s_wsq[WARPS];
  __shared__ int s_cnt[WARPS];

  const int nbj = m / TW;
  int bi, bj;
  if (symmetric) {
    // linear block id -> upper-triangle tile (bi, bj >= bi), row by row;
    // the loop is block-uniform and at most nbj long
    int t = blockIdx.x;
    int row = nbj;
    bi = 0;
    while (t >= row) {
      t -= row;
      --row;
      ++bi;
    }
    bj = bi + t;
  } else {
    bi = blockIdx.x / nbj;
    bj = blockIdx.x - bi * nbj;
  }

  // block-uniform: every thread takes the same branch
  const float skip_thres = scal[cvo::S_D2_THRES] + SKIP_MARGIN;
  if (md != nullptr && md[bi * nbj + bj] > skip_thres) {
    if (threadIdx.x == 0) {
      wsq_part[blockIdx.x] = 0.0f;
      cnt_part[blockIdx.x] = 0;
    }
    return;
  }

  const int i0 = bi * TW;
  for (int t = threadIdx.x; t < TW * 3; t += THREADS)
    s_x[t % 3][t / 3] = xp[3 * i0 + t];
  if constexpr (!USE_CK) {
    for (int t = threadIdx.x; t < TW * cvo::NFEAT; t += THREADS)
      s_f[t / cvo::NFEAT][t % cvo::NFEAT] = xf[cvo::NFEAT * i0 + t];
    for (int t = threadIdx.x; t < TW; t += THREADS) s_m[t] = xm[i0 + t];
  }
  __syncthreads();

  const int jj = threadIdx.x % TW;
  const int r0 = threadIdx.x / TW;
  const int j = bj * TW + jj;
  const float y0 = yp[3 * j], y1 = yp[3 * j + 1], y2 = yp[3 * j + 2];
  float fy[cvo::NFEAT];
  float ymj = 0.0f;
  if constexpr (!USE_CK) {
#pragma unroll
    for (int c = 0; c < cvo::NFEAT; ++c) fy[c] = yf[cvo::NFEAT * j + c];
    ymj = ym[j];
  }

  float acc = 0.0f;
  int cnt = 0;
  for (int ii = r0; ii < TW; ii += ROWS_PER_PASS) {
    const float d2 =
        cvo::sqdist3(s_x[0][ii], s_x[1][ii], s_x[2][ii], y0, y1, y2);
    float a;
    if constexpr (USE_CK) {
      a = cvo::pair_cached(d2, ck[static_cast<size_t>(i0 + ii) * m + j], scal);
    } else {
      a = cvo::pair_full(d2, s_f[ii], s_m[ii], fy, ymj, scal);
    }
    if (a > 0.0f) {
      ++cnt;
      acc = fmaf(a, d2, acc);
    }
  }

  // fixed-order block reduction
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if ((threadIdx.x & 31) == 0) {
    s_wsq[threadIdx.x >> 5] = acc;
    s_cnt[threadIdx.x >> 5] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float w = 0.0f;
    int c = 0;
    for (int k = 0; k < WARPS; ++k) {
      w += s_wsq[k];
      c += s_cnt[k];
    }
    // off-diagonal tiles of a symmetric sweep stand for their transpose
    const int weight = (symmetric && bj != bi) ? 2 : 1;
    wsq_part[blockIdx.x] = static_cast<float>(weight) * w;
    cnt_part[blockIdx.x] = weight * c;
  }
}

// out[0] = sum of the float partials, out[1] = sum of the int counts,
// one block, strided sums then a shared-memory tree: a fixed order.
__global__ void __launch_bounds__(RED_THREADS)
wsq_reduce_kernel(const float* __restrict__ wsq_part,
                  const int* __restrict__ cnt_part, float* __restrict__ out,
                  int n_parts) {
  __shared__ float s_w[RED_THREADS];
  __shared__ long long s_c[RED_THREADS];
  float w = 0.0f;
  long long c = 0;
  for (int t = threadIdx.x; t < n_parts; t += RED_THREADS) {
    w += wsq_part[t];
    c += cnt_part[t];
  }
  s_w[threadIdx.x] = w;
  s_c[threadIdx.x] = c;
  __syncthreads();
  for (int s = RED_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s_w[threadIdx.x] += s_w[threadIdx.x + s];
      s_c[threadIdx.x] += s_c[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = s_w[0];
    out[1] = static_cast<float>(s_c[0]);
  }
}

}  // namespace

// wsq_part: [n_parts] f32 scratch; cnt_part: [n_parts] i32 scratch;
// out: [2] f32 (wsq, nnz).  ck or md may be null.  n_parts is the number
// of launched tiles: nb * (nb + 1) / 2 when symmetric, else
// (n / TW) * (m / TW).
extern "C" int fused_wsq_launch(const float* xp, const float* xf,
                                const float* xm, const float* yp,
                                const float* yf, const float* ym,
                                const float* ck, const float* md,
                                const float* scal, float* wsq_part,
                                int* cnt_part, float* out, int n, int m,
                                int symmetric, int n_parts,
                                cudaStream_t stream) {
  if (ck != nullptr) {
    wsq_partial_kernel<true><<<n_parts, THREADS, 0, stream>>>(
        xp, xf, xm, yp, yf, ym, ck, md, scal, wsq_part, cnt_part, n, m,
        symmetric);
  } else {
    wsq_partial_kernel<false><<<n_parts, THREADS, 0, stream>>>(
        xp, xf, xm, yp, yf, ym, ck, md, scal, wsq_part, cnt_part, n, m,
        symmetric);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wsq_reduce_kernel<<<1, RED_THREADS, 0, stream>>>(wsq_part, cnt_part, out,
                                                   n_parts);
  return static_cast<int>(cudaGetLastError());
}
