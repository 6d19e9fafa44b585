// construct_probe: the Mosaic construct probes, one small kernel per case.
//
// Replaces the toy pallas_calls of scripts/tpu_construct_probe.py (cases
// a, b, b2, c, d, e) and scripts/tpu_construct_probe2.py (h, i, j, k).  On
// the TPU each case bisected one lowering construct of the tiled
// whole-align kernel; here each computes what its TPU case computes by the
// same construct in CUDA terms, into an [8, 128] f32 result:
//
//   a   a block's shared-memory scratch: s = 2x, out = s + 1;
//   b   an in-kernel loop with a scalar carry (acc = 1, 2, 3) adding
//       x[:, 0:256] * acc into the static column slice [:, 256:512] of an
//       [8, 1024] shared scratch; out = s[:, 256:384];
//   b2  a [128, 1024] scratch zeroed inside the loop, then += x[0:128, 0:256];
//   c   a (1, 160) row staged in shared memory and read as scalars:
//       out[0, :] = s[0] + s[159];
//   d   a store guarded by a device scalar (s[0] > -1, read every pass)
//       inside the loop: sc += 1, three times;
//   e   under the same guard, a 256-deep fp32 product (a^T b)[0:8, 0:128]
//       of a [256, 256] and b [256, 128], one IEEE FMA chain per output
//       (no TF32, no library call), added three times;
//   h   an offset column slice: the sum of x[256:512] of a (512, 1) column;
//   i   an offset row slice of a value: the sum of (2x)[256:512] of a row;
//   j   a broadcast outer difference of the two offset slices, squared
//       and reduced: sum (x[256 + i] - 2 y[256 + j])^2 over 256 x 256;
//   k   a momT-style [128, 512] scratch zeroed inside the loop, then
//       += 2 at column offset 256; out = s[0:8, 256:384].
//
// h, i and j write their sum into row 0 and zeros elsewhere, as the TPU
// cases do.  The TPU cases b, d and e read their VMEM scratch before
// writing it (undefined values); every scratch here starts at zero, which
// gives the closed forms of cvo_rgbd_torch/probes.py.
//
// Hopper limit: the scratches of b2 (512 KB) and k (256 KB) exceed a
// block's 227 KB of shared memory.  They live in device memory the wrapper
// allocates, split over 128 blocks, one scratch row a block, so the loop
// needs no grid-wide barrier (each block zeroes and updates only its row).
//
// Bound: each case moves a few KB to 1 MB and does at most 1.6 MFLOP (e),
// so every case is bound by bytes and, at this size, by its launch.
// Sums are in a fixed order (warp shuffles, then the warps in order).
#include <cuda_runtime.h>

namespace {

constexpr int OUT_ROWS = 8, OUT_COLS = 128, OUT = OUT_ROWS * OUT_COLS;
constexpr int NT = 256;

// Sum of v over a block of NT threads in a fixed order; valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[NT / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += warp_sums[w];
  return s;
}

// out[0, :] = v, zeros elsewhere (the TPU cases' where(row == 0, v, 0));
// v is valid in thread 0.
__device__ void write_row0(float v, float* out) {
  __shared__ float val;
  if (threadIdx.x == 0) val = v;
  __syncthreads();
  for (int t = threadIdx.x; t < OUT; t += NT)
    out[t] = t < OUT_COLS ? val : 0.0f;
}

__global__ void __launch_bounds__(NT) case_a(const float* x, float* out) {
  __shared__ float s[OUT];
  for (int t = threadIdx.x; t < OUT; t += NT) s[t] = x[t] * 2.0f;
  __syncthreads();
  for (int t = threadIdx.x; t < OUT; t += NT) out[t] = s[t] + 1.0f;
}

__global__ void __launch_bounds__(NT) case_b(const float* x, float* out) {
  __shared__ float s[OUT_ROWS][1024];
  for (int t = threadIdx.x; t < OUT_ROWS * 1024; t += NT) s[t / 1024][t % 1024] = 0.0f;
  __syncthreads();
  int k = 0;
  float acc = 1.0f;
  while (k < 3) {
    for (int t = threadIdx.x; t < OUT_ROWS * 256; t += NT) {
      const int r = t / 256, c = t % 256;
      s[r][256 + c] += x[r * 1024 + c] * acc;
    }
    __syncthreads();
    ++k;
    acc += 1.0f;
  }
  for (int t = threadIdx.x; t < OUT; t += NT)
    out[t] = s[t / OUT_COLS][256 + t % OUT_COLS];
}

// One block per scratch row of b2's [128, 1024] device scratch.
__global__ void __launch_bounds__(NT) case_b2(const float* x, float* out,
                                              float* scratch) {
  const int row = blockIdx.x;
  float* s = scratch + static_cast<size_t>(row) * 1024;
  for (int c = 0; c < 3; ++c) {
    for (int t = threadIdx.x; t < 1024; t += NT) s[t] = 0.0f;
    __syncthreads();
    for (int t = threadIdx.x; t < 256; t += NT) s[t] += x[row * 1024 + t];
    __syncthreads();
  }
  if (row < OUT_ROWS)
    for (int t = threadIdx.x; t < OUT_COLS; t += NT)
      out[row * OUT_COLS + t] = s[t];
}

__global__ void __launch_bounds__(NT) case_c(const float* srow, float* out) {
  __shared__ float row[160];
  for (int t = threadIdx.x; t < 160; t += NT) row[t] = srow[t];
  __syncthreads();
  const float v = row[0] + row[159];
  for (int t = threadIdx.x; t < OUT; t += NT)
    out[t] = t < OUT_COLS ? v : 0.0f;
}

__global__ void __launch_bounds__(NT) case_d(const float* sg, float* out) {
  __shared__ float sc[OUT];
  for (int t = threadIdx.x; t < OUT; t += NT) sc[t] = 0.0f;
  __syncthreads();
  for (int c = 0; c < 3; ++c) {
    if (sg[0] > -1.0f)
      for (int t = threadIdx.x; t < OUT; t += NT) sc[t] += 1.0f;
    __syncthreads();
  }
  for (int t = threadIdx.x; t < OUT; t += NT) out[t] = sc[t];
}

// 1024 threads, one output (i, j) each: sum_k a[k, i] b[k, j], k < 256.
__global__ void __launch_bounds__(OUT) case_e(const float* sg, const float* a,
                                              const float* b, float* out) {
  const int i = threadIdx.x / OUT_COLS, j = threadIdx.x % OUT_COLS;
  float sc = 0.0f;
  for (int c = 0; c < 3; ++c) {
    if (sg[0] > -1.0f) {
      float dot = 0.0f;
      for (int k = 0; k < 256; ++k)
        dot = __fmaf_rn(a[k * 256 + i], b[k * OUT_COLS + j], dot);
      sc = __fadd_rn(sc, dot);
    }
  }
  out[threadIdx.x] = sc;
}

__global__ void __launch_bounds__(NT) case_h(const float* x, float* out) {
  write_row0(block_sum(x[256 + threadIdx.x]), out);
}

__global__ void __launch_bounds__(NT) case_i(const float* x, float* out) {
  write_row0(block_sum(x[256 + threadIdx.x] * 2.0f), out);
}

__global__ void __launch_bounds__(NT) case_j(const float* x, const float* y,
                                             float* out) {
  const float xc = x[256 + threadIdx.x];
  float acc = 0.0f;
  for (int j = 0; j < 256; ++j) {
    const float d = xc - y[256 + j] * 2.0f;
    acc += d * d;
  }
  write_row0(block_sum(acc), out);
}

// One block per scratch row of k's [128, 512] device scratch.
__global__ void __launch_bounds__(NT) case_k(float* out, float* scratch) {
  const int row = blockIdx.x;
  float* s = scratch + static_cast<size_t>(row) * 512;
  for (int c = 0; c < 2; ++c) {
    for (int t = threadIdx.x; t < 512; t += NT) s[t] = 0.0f;
    __syncthreads();
    for (int t = threadIdx.x; t < 256; t += NT) s[256 + t] += 2.0f;
    __syncthreads();
  }
  if (row < OUT_ROWS)
    for (int t = threadIdx.x; t < OUT_COLS; t += NT)
      out[row * OUT_COLS + t] = s[256 + t];
}

}  // namespace

// Case numbers as cvo_rgbd_torch/probes.py:CASES (a b b2 c d e h i j k).
// in0..in2 are the case's inputs (unused ones null), out [8, 128], and
// scratch the device scratch of b2 [128, 1024] and k [128, 512] (else
// null).  Returns a cudaError_t.
extern "C" int construct_probe_launch(int which, const float* in0,
                                      const float* in1, const float* in2,
                                      float* out, float* scratch,
                                      cudaStream_t stream) {
  switch (which) {
    case 0: case_a<<<1, NT, 0, stream>>>(in0, out); break;
    case 1: case_b<<<1, NT, 0, stream>>>(in0, out); break;
    case 2: case_b2<<<128, NT, 0, stream>>>(in0, out, scratch); break;
    case 3: case_c<<<1, NT, 0, stream>>>(in0, out); break;
    case 4: case_d<<<1, NT, 0, stream>>>(in0, out); break;
    case 5: case_e<<<1, OUT, 0, stream>>>(in0, in1, in2, out); break;
    case 6: case_h<<<1, NT, 0, stream>>>(in0, out); break;
    case 7: case_i<<<1, NT, 0, stream>>>(in0, out); break;
    case 8: case_j<<<1, NT, 0, stream>>>(in0, in1, out); break;
    case 9: case_k<<<128, NT, 0, stream>>>(out, scratch); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
