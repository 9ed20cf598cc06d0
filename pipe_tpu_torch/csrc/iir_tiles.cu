// The tiled all-pole biquad recurrence, y[n] = v[n] - a1 y[n-1] - a2 y[n-2],
// over a (C, B) float32 block, for Hopper (sm_90a).
//
// Replaces the TPU kernel pipe_tpu/ops/biquad.py::_iir_tiles_pallas. That
// kernel walks B/256 tiles as a sequential grid; each tile is one
// (C, 256) x (256, 256) MXU product with the lower-triangular Toeplitz
// matrix of the impulse response g, plus the rank-2 boundary term
// y[-1] * alpha + y[-2] * beta, with the (C, 2) carry in VMEM scratch.
//
// Here: one CUDA block per 8 channels and 256 threads, one per position i
// of a tile. A loop over the tiles, in order, takes the place of the TPU's
// sequential grid. The dense 256x256 Toeplitz matrix (256 KB, more than a
// block's 227 KB of shared memory) is never formed: thread i indexes the
// product through g directly,
//
//   y[i] = sum_{j <= i} g[i - j] v[j] + carry0 * alpha[i] + carry1 * beta[i],
//
// reading g from a zero-padded copy in shared memory so that the j loop
// can run to the end of the warp's range (i | 31) without divergence. g,
// alpha and beta are computed in the prologue from a1, a2 with the same
// float64 recurrence as pipe_tpu_torch.ops.biquad._iir_sequences (three
// threads, one sequence each), so a call is a single launch.
//
// What bounds it on an H100: latency, not bytes or FLOPs. The tile loop is
// sequential, each tile costs every thread up to 256 dependent-free FMAs
// per channel, and only C/8 blocks exist (8 on 64 channels) for 132 SMs.
// The later fast version is tile-parallel in three passes: zero-state tile
// products for all tiles at once (a batched Toeplitz product), a 2x2 carry
// pass across tiles, then a boundary pass adding carry * (alpha, beta).
//
// Launch contract: runs on the given stream, allocates nothing, and returns
// cudaGetLastError(). a1 and a2 are device pointers (views into the live
// SOS tensor), so no host sync is needed to read the coefficients.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 256;  // tile length = threads per block
constexpr int kCB = 8;   // channels per block

__global__ void __launch_bounds__(kQ)
iir_tiles_kernel(const float* __restrict__ v, const float* __restrict__ s,
                 const float* __restrict__ a1p, const float* __restrict__ a2p,
                 float* __restrict__ y, int B) {
  // gz[m] = g[m - (kQ - 1)] for m >= kQ - 1 and 0 below, so that
  // y[i] = sum_j gz[i - j + kQ - 1] * v[j] over any j range covering [0, i].
  __shared__ float gz[2 * kQ];
  __shared__ float alpha[kQ];
  __shared__ float beta[kQ];
  __shared__ __align__(16) float vt[kQ][kCB];  // current tile, [j][channel]
  __shared__ float carry[kCB][2];              // (y[-1], y[-2]) per channel

  const int i = threadIdx.x;
  const int c0 = blockIdx.x * kCB;
  const float a1 = *a1p;
  const float a2 = *a2p;

  if (i < kQ - 1) gz[i] = 0.0f;
  if (i < 3) {
    // Values at n = 0 and n = -1: g (v = delta): 1, 0; alpha (y[-1] = 1):
    // -a1, 1; beta (y[-2] = 1): -a2, 0. In double, rounded step by step
    // like the eager torch ops of the plain version, and each value rounded
    // once to float: near DC the sequences grow from cancelling terms.
    const double da1 = a1;
    const double da2 = a2;
    double y1 = i == 0 ? 1.0 : (i == 1 ? -da1 : -da2);
    double y2 = i == 1 ? 1.0 : 0.0;
    float* out = i == 0 ? gz + (kQ - 1) : (i == 1 ? alpha : beta);
    out[0] = __double2float_rn(y1);
    for (int n = 1; n < kQ; ++n) {
      const double yn = __dsub_rn(__dmul_rn(-da1, y1), __dmul_rn(da2, y2));
      out[n] = __double2float_rn(yn);
      y2 = y1;
      y1 = yn;
    }
  }
  if (i < 2 * kCB) carry[i >> 1][i & 1] = s[(c0 + (i >> 1)) * 2 + (i & 1)];

  const float* vb = v + static_cast<size_t>(c0) * B;
  float* yb = y + static_cast<size_t>(c0) * B;
  const int n_tiles = B / kQ;
  const int jmax = i | 31;  // warp-uniform trip count

  for (int t = 0; t < n_tiles; ++t) {
    const int col = t * kQ + i;
    const float4 in_lo = make_float4(vb[col], vb[B + col], vb[2 * B + col],
                                     vb[3 * B + col]);
    const float4 in_hi = make_float4(vb[4 * B + col], vb[5 * B + col],
                                     vb[6 * B + col], vb[7 * B + col]);
    *reinterpret_cast<float4*>(&vt[i][0]) = in_lo;
    *reinterpret_cast<float4*>(&vt[i][4]) = in_hi;
    __syncthreads();  // tile, carry (and at t == 0 the sequences) ready

    float acc[kCB];
#pragma unroll
    for (int c = 0; c < kCB; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int j = 0; j <= jmax; ++j) {
      const float gv = gz[i - j + kQ - 1];
      const float4 lo = *reinterpret_cast<const float4*>(&vt[j][0]);
      const float4 hi = *reinterpret_cast<const float4*>(&vt[j][4]);
      acc[0] = fmaf(gv, lo.x, acc[0]);
      acc[1] = fmaf(gv, lo.y, acc[1]);
      acc[2] = fmaf(gv, lo.z, acc[2]);
      acc[3] = fmaf(gv, lo.w, acc[3]);
      acc[4] = fmaf(gv, hi.x, acc[4]);
      acc[5] = fmaf(gv, hi.y, acc[5]);
      acc[6] = fmaf(gv, hi.z, acc[6]);
      acc[7] = fmaf(gv, hi.w, acc[7]);
    }
    const float al = alpha[i];
    const float be = beta[i];
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
      acc[c] = acc[c] + carry[c][0] * al + carry[c][1] * be;
      yb[static_cast<size_t>(c) * B + col] = acc[c];
    }
    __syncthreads();  // every thread is done with this tile and carry
    if (i == kQ - 1) {
#pragma unroll
      for (int c = 0; c < kCB; ++c) carry[c][0] = acc[c];
    } else if (i == kQ - 2) {
#pragma unroll
      for (int c = 0; c < kCB; ++c) carry[c][1] = acc[c];
    }
  }
}

}  // namespace

extern "C" int pipe_iir_tiles(const float* v, const float* s, const float* a1,
                              const float* a2, float* y, int C, int B,
                              void* stream) {
  if (C <= 0 || B <= 0 || C % kCB != 0 || B % kQ != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  iir_tiles_kernel<<<C / kCB, kQ, 0, static_cast<cudaStream_t>(stream)>>>(
      v, s, a1, a2, y, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pipe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
