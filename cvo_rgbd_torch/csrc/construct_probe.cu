// construct_probe: the Mosaic construct probes, one small kernel per case.
//
// Replaces the toy pallas_calls of scripts/tpu_construct_probe.py (cases
// a, b, b2, c, d, e) and scripts/tpu_construct_probe2.py (h, i, j, k).  On
// the TPU each case bisected one lowering construct of the tiled
// whole-align kernel; here each computes what its TPU case computes, the
// same [8, 128] f32 result from the same inputs.  Where the script's
// construct costs time on this card and does not reach the result, the
// kernel drops it:
//
//   a   out = 2x + 1 through a block's shared-memory scratch, as the
//       script stages it.
//   b   the script's loop (acc = 1, 2, 3) adds x[:, 0:256] * acc into
//       s[:, 256:512] of an [8, 1024] scratch and reads s[:, 256:384].
//       Kept: the three passes, each product and each add rounded apart
//       (__fmul_rn, then __fadd_rn) in that order from 0, as the plain
//       version rounds them.  Dropped: the scratch; each output element
//       lives in a register across the passes, and only the 1024 that
//       reach the result are computed.
//   b2  a [128, 1024] scratch zeroed inside a three-pass loop, then
//       += x[0:128, 0:256]; out = s[0:8, 0:128].  Kept: zero, then add,
//       per pass (0 + x, so -0 reads back +0 as in the plain version).
//       Dropped: the 120 rows and 896 columns that never reach the
//       result, and with them the 512 KB device scratch; the 1024 outputs
//       live in registers.
//   c   a (1, 160) row staged in shared memory and read as scalars:
//       out[0, :] = s[0] + s[159].
//   d   a guard s[0] > -1 around += 1 on an [8, 128] scratch, in a
//       three-pass loop.  Kept: the three guarded adds from 0, in order.
//       The guard is read once: nothing writes it during the launch, so
//       each pass would read the same value.  Dropped: the shared scratch;
//       the sum lives in a register.
//   e   under the same guard, += (a^T b)[0:8, 0:128] three times, a
//       [256, 256] and b [256, 128].  Kept: one IEEE FMA chain per output
//       in k order (no TF32, no library call), so e keeps its bits on any
//       input, and the three adds of that dot, in order from 0.  Dropped:
//       computing the same dot three times; the three adds are of one
//       value.  A guard <= -1 (or NaN) gives zeros.
//   h   the sum of x[256:512] of a (512, 1) column, in row 0.
//   i   the sum of (2x)[256:512] of a (1, 512) row, in row 0.
//   j   sum (x[256 + i] - 2 y[256 + j])^2 over 256 x 256, in row 0.  The
//       order of the sum: thread t of 1024 takes i = t % 256 and the 64
//       j of quarter t / 256 in ascending order, one FMA chain
//       (d = x - 2y rounded, acc = fma(d, d, acc)); then each warp's 32
//       partials by shuffles (offsets 16, 8, 4, 2, 1), then the 32 warps'
//       sums in warp order the same way.
//   k   a [128, 512] scratch zeroed inside a two-pass loop, then += 2 at
//       column offset 256; out = s[0:8, 256:384].  Kept: zero, then add
//       2, per pass.  Dropped: the 256 KB device scratch and the rows
//       and columns that never reach the result.  k reads no input.
//
// h, i and j write their sum into row 0 and zeros elsewhere, as the TPU
// cases do.  The TPU cases b, d and e read their VMEM scratch before
// writing it (undefined values); every sum here starts at zero, which
// gives the closed forms of cvo_rgbd_torch/probes.py on the scripts'
// inputs.
//
// Bound: each case moves at most 136 KB (e) and does at most 1.6 MFLOP
// (e's three products, of which one is computed), so at this size every
// case is bound by its launch: about 5.4 us on CUDA events against a
// bound below 0.05 us.  The design keeps each case one launch of one
// short pass: no device scratch, no block barrier where none is needed,
// and 16-byte loads and stores where a case reads or writes whole rows
// (b, b2, d, e, j, k).  e is bound besides by its chain: 256 dependent
// FMAs an output.  Its 1024 outputs are spread over 16 blocks of 64 (8
// rows x 8 columns), each staging a[:, 0:8] and its 8 columns of b in
// shared memory with 16-byte loads, transposed so that the chain reads
// four k of each operand in one 16-byte shared load, and the k loop
// unrolled so the shared loads run ahead of the FMAs; j's 65536 pairs
// over 1024 threads with 2y[256:512] staged once in shared memory.
// The wrapper checks that every input is 16-byte aligned.
#include <cuda_runtime.h>

namespace {

constexpr int OUT_ROWS = 8, OUT_COLS = 128, OUT = OUT_ROWS * OUT_COLS;
constexpr int NT = 256;
// NT threads write the [8, 128] result as NT float4s
static_assert(OUT == 4 * NT, "one float4 of the result a thread");
// e: a block's outputs are E_ROWS x E_COLS, blocks along the columns
constexpr int E_ROWS = OUT_ROWS, E_COLS = 8, E_NT = E_ROWS * E_COLS;
constexpr int E_BLOCKS = OUT_COLS / E_COLS, E_DEPTH = 256, E_LDA = 256;
constexpr int E_PAD = E_DEPTH + 4;
// j: 1024 threads over 256 x 256 pairs, 64 j a thread
constexpr int J_NT = 1024, J_N = 256, J_PER = J_N * J_N / J_NT;

__device__ float4 add4(float4 s, float4 v) {
  return make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                     __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
}

__device__ float4 mul4(float4 v, float c) {
  return make_float4(__fmul_rn(v.x, c), __fmul_rn(v.y, c),
                     __fmul_rn(v.z, c), __fmul_rn(v.w, c));
}

__device__ float4 splat4(float v) { return make_float4(v, v, v, v); }

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

// Thread t: the four outputs out[r, c:c+4], r = t / 32, c = 4 (t % 32).
__global__ void __launch_bounds__(NT) case_b(const float* x, float* out) {
  const int r = threadIdx.x / 32, c = 4 * (threadIdx.x % 32);
  const float4 v = *reinterpret_cast<const float4*>(x + r * 1024 + c);
  float4 s = splat4(0.0f);
  float acc = 1.0f;
  for (int k = 0; k < 3; ++k) {
    s = add4(s, mul4(v, acc));
    acc = __fadd_rn(acc, 1.0f);
  }
  reinterpret_cast<float4*>(out)[threadIdx.x] = s;
}

__global__ void __launch_bounds__(NT) case_b2(const float* x, float* out) {
  const int r = threadIdx.x / 32, c = 4 * (threadIdx.x % 32);
  const float4 v = *reinterpret_cast<const float4*>(x + r * 1024 + c);
  float4 s;
  for (int k = 0; k < 3; ++k) {
    s = splat4(0.0f);
    s = add4(s, v);
  }
  reinterpret_cast<float4*>(out)[threadIdx.x] = s;
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
  const bool on = sg[0] > -1.0f;
  float sc = 0.0f;
  for (int k = 0; k < 3; ++k)
    if (on) sc = __fadd_rn(sc, 1.0f);
  reinterpret_cast<float4*>(out)[threadIdx.x] = splat4(sc);
}

// Block bx: the outputs (i, 8 bx + jj), thread i + 8 jj.  Each thread's
// dot is one __fmaf_rn chain over k = 0..255 from 0.  a[:, 0:8] and
// b[:, 8 bx:8 bx + 8] are staged transposed, each row padded to E_PAD
// floats so that a warp's 16-byte reads of its 8 rows of sa (and 4 of
// sb) fall in distinct banks.
__global__ void __launch_bounds__(E_NT) case_e(const float* sg,
                                               const float* a,
                                               const float* b, float* out) {
  const int i = threadIdx.x % E_ROWS, jj = threadIdx.x / E_ROWS;
  const int j0 = blockIdx.x * E_COLS;
  const bool on = sg[0] > -1.0f;  // the same in every thread
  float sc = 0.0f;
  if (on) {
    __shared__ __align__(16) float sa[E_ROWS][E_PAD];
    __shared__ __align__(16) float sb[E_COLS][E_PAD];
    // two float4s a row of a[:, 0:8] and of b's 8 columns
    for (int t = threadIdx.x; t < 2 * E_DEPTH; t += E_NT) {
      const int k = t / 2, h = 4 * (t % 2);
      const float4 va = *reinterpret_cast<const float4*>(a + k * E_LDA + h);
      const float4 vb =
          *reinterpret_cast<const float4*>(b + k * OUT_COLS + j0 + h);
      sa[h][k] = va.x; sa[h + 1][k] = va.y; sa[h + 2][k] = va.z;
      sa[h + 3][k] = va.w;
      sb[h][k] = vb.x; sb[h + 1][k] = vb.y; sb[h + 2][k] = vb.z;
      sb[h + 3][k] = vb.w;
    }
    __syncthreads();
    float dot = 0.0f;
#pragma unroll 8
    for (int k = 0; k < E_DEPTH; k += 4) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[i][k]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[jj][k]);
      dot = __fmaf_rn(av.x, bv.x, dot);
      dot = __fmaf_rn(av.y, bv.y, dot);
      dot = __fmaf_rn(av.z, bv.z, dot);
      dot = __fmaf_rn(av.w, bv.w, dot);
    }
    for (int c = 0; c < 3; ++c) sc = __fadd_rn(sc, dot);
  }
  out[i * OUT_COLS + j0 + jj] = sc;
}

__global__ void __launch_bounds__(NT) case_h(const float* x, float* out) {
  write_row0(block_sum(x[256 + threadIdx.x]), out);
}

__global__ void __launch_bounds__(NT) case_i(const float* x, float* out) {
  write_row0(block_sum(x[256 + threadIdx.x] * 2.0f), out);
}

// Warp-order sum of v over a warp by shuffles; valid in lane 0.
__device__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(J_NT) case_j(const float* x, const float* y,
                                               float* out) {
  __shared__ __align__(16) float y2[J_N];
  __shared__ float warp_sums[J_NT / 32];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (t < J_N / 4) {
    const float4 v = reinterpret_cast<const float4*>(y + J_N)[t];
    reinterpret_cast<float4*>(y2)[t] = mul4(v, 2.0f);
  }
  // rows 1-7 of the result are zeros, written while the sum runs
  if (t >= OUT_COLS / 4 && t < OUT / 4)
    reinterpret_cast<float4*>(out)[t] = splat4(0.0f);
  const float xi = x[J_N + t % J_N];
  const float* yq = y2 + (t / J_N) * J_PER;  // the same in a whole warp
  __syncthreads();
  float acc = 0.0f;
#pragma unroll 16
  for (int j = 0; j < J_PER; ++j) {
    const float d = __fsub_rn(xi, yq[j]);
    acc = __fmaf_rn(d, d, acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const float s = __shfl_sync(0xffffffffu, warp_sum(warp_sums[lane]), 0);
    reinterpret_cast<float4*>(out)[lane] = splat4(s);
  }
}

__global__ void __launch_bounds__(NT) case_k(float* out) {
  float4 s;
  for (int k = 0; k < 2; ++k) {
    s = splat4(0.0f);
    s = add4(s, splat4(2.0f));
  }
  reinterpret_cast<float4*>(out)[threadIdx.x] = s;
}

}  // namespace

// Case numbers as cvo_rgbd_torch/probes.py:CASES (a b b2 c d e h i j k).
// in0..in2 are the case's inputs (unused ones null, every one 16-byte
// aligned) and out the [8, 128] result.  Returns a cudaError_t.
extern "C" int construct_probe_launch(int which, const float* in0,
                                      const float* in1, const float* in2,
                                      float* out, cudaStream_t stream) {
  switch (which) {
    case 0: case_a<<<1, NT, 0, stream>>>(in0, out); break;
    case 1: case_b<<<1, NT, 0, stream>>>(in0, out); break;
    case 2: case_b2<<<1, NT, 0, stream>>>(in0, out); break;
    case 3: case_c<<<1, NT, 0, stream>>>(in0, out); break;
    case 4: case_d<<<1, NT, 0, stream>>>(in0, out); break;
    case 5: case_e<<<E_BLOCKS, E_NT, 0, stream>>>(in0, in1, in2, out); break;
    case 6: case_h<<<1, NT, 0, stream>>>(in0, out); break;
    case 7: case_i<<<1, NT, 0, stream>>>(in0, out); break;
    case 8: case_j<<<1, J_NT, 0, stream>>>(in0, in1, out); break;
    case 9: case_k<<<1, NT, 0, stream>>>(out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
