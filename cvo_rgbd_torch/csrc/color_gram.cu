// color_gram: the [N,M] masked color-kernel cache of one point-cloud pair.
//
// Replaces the JAX package's ops/pallas_gram.py:color_gram (_color_kernel):
// ck_ij = cs2 * exp_neg(|f_i - f_j|^2 / 2 c_ell^2), zero where the color
// gate d2c < d2_c_thres or either validity mask fails.  Built once per
// pair; the moment kernel reads it every iteration.
//
// Bound on the H100: the N*M*4-byte store (37.7 MB at N=M=3072, ~11 us
// at 3.35 TB/s); the ~40 fp32 operations per entry take half that.  The
// design serves the store: one thread per entry, consecutive threads on
// consecutive j, so every warp writes 128 contiguous bytes; each thread
// reads its two 5-feature rows straight from global memory (the i row
// is one broadcast per warp, the j rows a contiguous 640-byte run).
#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace {

constexpr int BX = 128;  // j per block
constexpr int BY = 2;    // i per block

__global__ void __launch_bounds__(BX * BY)
color_gram_kernel(const float* __restrict__ xf, const float* __restrict__ xm,
                  const float* __restrict__ yf, const float* __restrict__ ym,
                  const float* __restrict__ scal, float* __restrict__ out,
                  int n, int m) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= n || j >= m) return;
  float d2c;
  const float ck = cvo::color_kernel(xf + cvo::NFEAT * i,
                                     yf + cvo::NFEAT * j, scal, &d2c);
  const bool gate =
      d2c < scal[cvo::S_D2_C_THRES] && xm[i] > 0.0f && ym[j] > 0.0f;
  out[static_cast<size_t>(i) * m + j] = gate ? ck : 0.0f;
}

}  // namespace

extern "C" int color_gram_launch(const float* xf, const float* xm,
                                 const float* yf, const float* ym,
                                 const float* scal, float* out, int n, int m,
                                 cudaStream_t stream) {
  const dim3 block(BX, BY);
  const dim3 grid((m + BX - 1) / BX, (n + BY - 1) / BY);
  color_gram_kernel<<<grid, block, 0, stream>>>(xf, xm, yf, ym, scal, out, n,
                                                m);
  return static_cast<int>(cudaGetLastError());
}
