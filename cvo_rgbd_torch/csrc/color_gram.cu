// color_gram: the [B,N,M] masked color-kernel caches of B point-cloud pairs.
//
// Replaces the JAX package's ops/pallas_gram.py:color_gram (_color_kernel),
// and its vmap over a batch of pairs: ck_ij = cs2 * exp_neg(|f_i - f_j|^2 /
// 2 c_ell^2), zero where the color gate d2c < d2_c_thres or either validity
// mask fails.  Built once per pair; the moment kernel reads it every
// iteration.  The lane (pair) is grid z, one launch a batch: a lane's
// entries are computed as the one-pair launch computes them, so lane b of
// a batch is the bits of the launch on pair b alone (B = 1).
//
// Bound on the H100: the N*M*4-byte store (37.7 MB at N=M=3072, ~11 us
// at 3.35 TB/s).  The ~32 instructions an entry (the 5-feature d2c,
// exp_neg, the gate) take about as long again at the card's issue rate,
// so the design keeps every other instruction out of the entry:
//   - one block an output tile of TR rows x 256 columns; a thread holds
//     the features and masks of 4 consecutive columns in registers, read
//     once, and the scalars in registers;
//   - the tile's rows are staged once in shared memory, structure of
//     arrays, and every thread of a warp reads a row's 6 values as one
//     broadcast each, shared by its 4 entries;
//   - a thread writes one float4 a row: 16 bytes a thread, 512
//     contiguous bytes a warp.  Where M % 4 != 0 the rows are not 16-byte
//     aligned, and every entry is stored alone (a scalar tail);
//   - the entry is cvo::color_kernel and the gate as written, with the
//     same operands, so the cache is the one-thread-an-entry design's
//     bits.  No fast math (pair_tile.cuh).
// Streaming stores, 16- and 64-row tiles, and a rounding in exp_neg
// without the quarter-rate rintf / F2I were measured no faster (PERF.md
// §6).
#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace {

constexpr int CW = 4;          // columns a thread
constexpr int TX = 64;         // threads across a tile: 256 columns
constexpr int TY = 4;          // thread rows
constexpr int TR = 32;         // rows a tile
constexpr int THREADS = TX * TY;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
color_gram_kernel(const float* __restrict__ xf, const float* __restrict__ xm,
                  const float* __restrict__ yf, const float* __restrict__ ym,
                  const float* __restrict__ scal, float* __restrict__ out,
                  int n, int m) {
  // this block's lane: its clouds and its [n, m] output
  const size_t lane = blockIdx.z;
  xf += lane * n * cvo::NFEAT;
  xm += lane * n;
  yf += lane * m * cvo::NFEAT;
  ym += lane * m;
  out += lane * n * m;
  __shared__ float s_f[cvo::NFEAT][TR];
  __shared__ float s_m[TR];
  const int i0 = blockIdx.y * TR;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int t = tid; t < TR * cvo::NFEAT; t += THREADS) {
    const int r = t / cvo::NFEAT, i = i0 + r;
    s_f[t % cvo::NFEAT][r] =
        i < n ? xf[static_cast<size_t>(cvo::NFEAT) * i0 + t] : 0.0f;
  }
  for (int t = tid; t < TR; t += THREADS)
    s_m[t] = i0 + t < n ? xm[i0 + t] : 0.0f;

  const int j0 = (blockIdx.x * TX + threadIdx.x) * CW;
  float fy[CW][cvo::NFEAT];
  bool yok[CW];
#pragma unroll
  for (int q = 0; q < CW; ++q) {
    const int j = min(j0 + q, m - 1);
#pragma unroll
    for (int c = 0; c < cvo::NFEAT; ++c)
      fy[q][c] = yf[static_cast<size_t>(cvo::NFEAT) * j + c];
    yok[q] = ym[j] > 0.0f;
  }
  const float thres = scal[cvo::S_D2_C_THRES];
  __syncthreads();
  if (j0 >= m) return;

  for (int r = threadIdx.y; r < TR && i0 + r < n; r += TY) {
    float fx[cvo::NFEAT];
#pragma unroll
    for (int c = 0; c < cvo::NFEAT; ++c) fx[c] = s_f[c][r];
    const bool xok = s_m[r] > 0.0f;
    float v[CW];
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      float d2c;
      const float ck = cvo::color_kernel(fx, fy[q], scal, &d2c);
      v[q] = (d2c < thres && xok && yok[q]) ? ck : 0.0f;
    }
    float* row = out + static_cast<size_t>(i0 + r) * m + j0;
    if (VEC) {
      // m % 4 == 0: a chunk is in range whole or not at all
      *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < CW; ++q)
        if (j0 + q < m) row[q] = v[q];
    }
  }
}

}  // namespace

// xf [b, n, 5], xm [b, n], yf [b, m, 5], ym [b, m], out [b, n, m] f32,
// contiguous; out's rows 16-byte aligned when m % 4 == 0 (a fresh
// allocation is).  b is grid z: at most 65535 lanes.
extern "C" int color_gram_launch(const float* xf, const float* xm,
                                 const float* yf, const float* ym,
                                 const float* scal, float* out, int b, int n,
                                 int m, cudaStream_t stream) {
  if (b < 1 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(TX, TY);
  const dim3 grid((m + TX * CW - 1) / (TX * CW), (n + TR - 1) / TR, b);
  if (m % CW == 0) {
    color_gram_kernel<true><<<grid, block, 0, stream>>>(xf, xm, yf, ym, scal,
                                                        out, n, m);
  } else {
    color_gram_kernel<false><<<grid, block, 0, stream>>>(xf, xm, yf, ym,
                                                         scal, out, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
