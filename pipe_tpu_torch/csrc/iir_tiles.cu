// The tiled all-pole biquad recurrence, y[n] = v[n] - a1 y[n-1] - a2 y[n-2],
// over a (C, B) float32 block, and one whole biquad EQ section around it,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel pipe_tpu/ops/biquad.py::_iir_tiles_pallas. That
// kernel walks B/256 tiles as a sequential grid; each tile is one
// (C, 256) x (256, 256) MXU product with the lower-triangular Toeplitz
// matrix Tl of the impulse response g, plus the rank-2 boundary term
// y[-1] * alpha + y[-2] * beta, with the (C, 2) carry in VMEM scratch. On
// the TPU the section's FIR part, the refinement defect and the state
// update fuse around that call; here they are part of the kernels.
//
// What bounds it on an H100: the bytes are few (v read, y written: 1.6 us
// at (64, 10240)) and the dense tile products are ~5 us of FP32 FMAs, so a
// form that walks the tiles in order is bound by latency: 8 blocks on 132
// SMs, ~6.5 us a tile. What the design does about it: the tile products do
// not depend on the carry, so they run for all tiles at once, and only the
// carry itself (two FMAs a tile and channel) is walked in order.
//
//   1. product:  z = Tl v for every (tile, 8 channels) pair, one CUDA block
//      each: grid ceil(B/256) x (C/8). A thread owns 4 consecutive outputs of 2
//      channels in registers and slides a window of g over them, so 4 steps
//      of j cost three 16-byte shared loads for 32 FMAs. The sums run in
//      ascending j, one FMA a term. The tile's last two outputs also go to
//      a small (C, T, 2) array.
//   2. carry:    c[t+1] = (z[t,255] + c0 alpha[255] + c1 beta[255],
//                          z[t,254] + c0 alpha[254] + c1 beta[254]), c[0] = s.
//      Every block of the next kernel walks this chain for its own tile from
//      that array (at most T steps of two dependent FMAs), so no block waits
//      for another and there is no separate carry launch.
//   3. boundary: y = z + c0[t] alpha + c1[t] beta, written once. The carry a
//      tile hands on and the y it writes come from one function (boundary()),
//      so they are the same floats.
//
// g, alpha and beta: g[n] is the first entry of M^n (1, 0) with the companion
// matrix M = [[-a1, -a2], [1, 0]], alpha[n] = g[n+1], beta[n] = -a2 g[n]. One
// warp of every block forms them in float64: lane l takes M^(8l) from the
// squarings M^8 .. M^128 and then 8 steps of the recurrence, ~40 dependent
// operations instead of 256, and each value is rounded once to float32.
// Near DC these responses grow to ~100 from terms that cancel, which
// float32 products would lose.
//
// pipe_iir_tiles: product, then boundary (2 kernels).
// pipe_biquad_section: the whole section of ops/biquad.py::
// biquad_section_block in 2 kernels, or 3 with the refinement pass:
//   product<fir>: v = b0 x[n] + b1 x[n-1] + b2 x[n-2] over [x_tail, x zeroed
//     from `frames` on] formed in the tile load (each product and sum rounded,
//     left to right), z = Tl v; also the new x_tail;
//   refine: y0 = boundary(z); the defect r = v - (y0 + a1 y0[-1] + a2 y0[-2])
//     in float64 with exact products, rounded once (a tile's y0[-1], y0[-2]
//     are its incoming carry); z' = Tl r;
//   finish: y = y0 + boundary'(z') with the second chain from a zero state
//     (without refinement: y = boundary(z)), and the state after the last
//     valid frame.
//
// The partial last tile: B need not be a multiple of 256. The last tile's
// positions from B on are read as 0 and never stored. The recurrence is
// causal, so whatever lies past B changes no output before it, and the last
// tile's entry in the (C, T, 2) array is never read: a tile's carry walks
// only the tiles before it. The guard is one branch, uniform over a CUDA
// block (whole_tile()), so the whole tiles run the code they ran before.
// float4 stores need rows that start 16-byte aligned (B % 4 == 0); otherwise
// every tile takes the guarded path and stores scalars.
//
// Launch contract: every kernel runs on the given stream, nothing is
// allocated here (outputs and scratch come from the caller), and each entry
// point returns cudaGetLastError(). Coefficients are read from device memory
// (views into the live SOS tensor), so no host sync is needed.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 256;      // tile length = threads per block
constexpr int kCB = 8;       // channels per block
constexpr int kPad = 64;     // zeros in front of g: gz[kPad + m] = g[m]
constexpr int kChunk = 64;   // tiles of the carry chain staged at a time

struct Sequences {
  __align__(16) float gz[kPad + kQ];
  float alpha[kQ];
  float beta[kQ];
};

// A 2x2 float64 matrix, for the powers of the companion matrix.
struct Mat2 {
  double m00, m01, m10, m11;
  __device__ __forceinline__ void square() {
    const double n00 = m00 * m00 + m01 * m10, n01 = m00 * m01 + m01 * m11;
    const double n10 = m10 * m00 + m11 * m10, n11 = m10 * m01 + m11 * m11;
    m00 = n00; m01 = n01; m10 = n10; m11 = n11;
  }
};

// One warp (lane = 0..31) fills seq from a1, a2; see the header.
__device__ void fill_sequences(Sequences& seq, float a1f, float a2f, int lane) {
  const double a1 = a1f, a2 = a2f;
  Mat2 m = {-a1, -a2, 1.0, 0.0};  // M^(2^k)
  m.square(); m.square(); m.square();  // M^8
  double w0 = 1.0, w1 = 0.0;     // (g[n], g[n-1]) at n = 0
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    if ((lane >> b) & 1) {
      const double t0 = m.m00 * w0 + m.m01 * w1;
      const double t1 = m.m10 * w0 + m.m11 * w1;
      w0 = t0; w1 = t1;
    }
    if (b < 4) m.square();
  }
  // w = (g[8 lane], g[8 lane - 1]); the warp also zeroes the padding
  seq.gz[lane] = 0.0f;
  seq.gz[lane + 32] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int n = 8 * lane + k;
    seq.gz[kPad + n] = __double2float_rn(w0);
    seq.beta[n] = __double2float_rn(-a2 * w0);
    if (n > 0) seq.alpha[n - 1] = __double2float_rn(w0);
    const double next = -a1 * w0 - a2 * w1;
    w1 = w0;
    w0 = next;
  }
  if (lane == 31) seq.alpha[kQ - 1] = __double2float_rn(w0);  // g[256]
}

// Tiles of a B-frame row, the last one possibly partial.
__host__ __device__ __forceinline__ int num_tiles(int B) {
  return (B + kQ - 1) / kQ;
}

// Whether tile t lies wholly inside the row and the row starts 16-byte
// aligned: the same answer for every thread of a CUDA block.
__device__ __forceinline__ bool whole_tile(int t, int B) {
  return t < B / kQ && B % 4 == 0;
}

// A tile position's output from its zero-state product and the tile's
// incoming carry. The carry chain and the written y both use this.
__device__ __forceinline__ float boundary(float z, float c0, float al,
                                          float c1, float be) {
  return fmaf(c1, be, fmaf(c0, al, z));
}

// z = Tl vt for the block's 8 channels: thread `tid` owns outputs
// i0 .. i0+3 of channels ca, ca+1 (out[0][*], out[1][*]).
struct Owner {
  int i0, ca, jend;
};

__device__ __forceinline__ Owner owner_of(int tid) {
  const int w = tid >> 5, lane = tid & 31;
  // warp -> (quarter of the positions, half of the channels); warps w and
  // w + 4 take quarters q and 3 - q, so each pair does the same work
  const int quarter = w < 4 ? w : 7 - w;
  const int half = w >> 2;
  Owner o;
  o.i0 = 4 * (quarter * 16 + (lane & 15));
  o.ca = 2 * (half * 2 + (lane >> 4));
  o.jend = 64 * (quarter + 1);  // warp-uniform, covers j <= i0 + 3
  return o;
}

__device__ __forceinline__ void tile_product(const float (*vt)[kQ],
                                             const float* gz, const Owner& o,
                                             float (&out)[2][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) out[0][r] = out[1][r] = 0.0f;
  // hi = g[k .. k+3], lo = g[k-4 .. k-1] with k = i0 - j0
  float4 hi = *reinterpret_cast<const float4*>(&gz[kPad + o.i0]);
#pragma unroll 2
  for (int j0 = 0; j0 < o.jend; j0 += 4) {
    const float4 lo =
        *reinterpret_cast<const float4*>(&gz[kPad + o.i0 - j0 - 4]);
    const float4 va = *reinterpret_cast<const float4*>(&vt[o.ca][j0]);
    const float4 vb = *reinterpret_cast<const float4*>(&vt[o.ca + 1][j0]);
    // j = j0 + d multiplies g[k - d + r] into output r
    const float g0[4] = {hi.x, hi.y, hi.z, hi.w};
    const float g1[4] = {lo.w, hi.x, hi.y, hi.z};
    const float g2[4] = {lo.z, lo.w, hi.x, hi.y};
    const float g3[4] = {lo.y, lo.z, lo.w, hi.x};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      out[0][r] = fmaf(g0[r], va.x, out[0][r]);
      out[1][r] = fmaf(g0[r], vb.x, out[1][r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      out[0][r] = fmaf(g1[r], va.y, out[0][r]);
      out[1][r] = fmaf(g1[r], vb.y, out[1][r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      out[0][r] = fmaf(g2[r], va.z, out[0][r]);
      out[1][r] = fmaf(g2[r], vb.z, out[1][r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      out[0][r] = fmaf(g3[r], va.w, out[0][r]);
      out[1][r] = fmaf(g3[r], vb.w, out[1][r]);
    }
    hi = lo;
  }
}

// Write the owner's outputs to z (C, B) and the tile's last two to zl (C, T, 2).
// kTail: only the outputs before B, as one float4 where the row is aligned.
template <bool kTail>
__device__ __forceinline__ void store_product(const float (&out)[2][4],
                                              const Owner& o, float* z,
                                              float* zl, int c0, int t, int B) {
  const int T = num_tiles(B);
  const int n0 = t * kQ + o.i0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t c = c0 + o.ca + h;
    float* row = &z[c * B];
    if (!kTail) {
      *reinterpret_cast<float4*>(&row[n0]) =
          make_float4(out[h][0], out[h][1], out[h][2], out[h][3]);
    } else if (B % 4 == 0) {
      if (n0 < B) {
        *reinterpret_cast<float4*>(&row[n0]) =
            make_float4(out[h][0], out[h][1], out[h][2], out[h][3]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (n0 + r < B) row[n0 + r] = out[h][r];
      }
    }
    if (o.i0 == kQ - 4) {
      zl[(c * T + t) * 2 + 0] = out[h][3];
      zl[(c * T + t) * 2 + 1] = out[h][2];
    }
  }
}

// The incoming carry of tile t for the block's 8 channels into carry[c][0..1]
// = (y[-1], y[-2]): the chain from `s` (or zero when s is null) over the last
// two zero-state outputs zl of tiles 0 .. t-1. Ends with a __syncthreads().
__device__ void tile_carry(float (*carry)[2], float (*stage)[2 * kChunk],
                           const Sequences& seq, const float* s,
                           const float* zl, int c0, int t, int T, int tid) {
  float k0 = 0.0f, k1 = 0.0f;
  if (tid < kCB && s != nullptr) {
    k0 = s[(c0 + tid) * 2];
    k1 = s[(c0 + tid) * 2 + 1];
  }
  const float al1 = seq.alpha[kQ - 1], be1 = seq.beta[kQ - 1];
  const float al2 = seq.alpha[kQ - 2], be2 = seq.beta[kQ - 2];
  for (int base = 0; base < t; base += kChunk) {
    const int n = min(kChunk, t - base);
    __syncthreads();  // the stage is free
    for (int idx = tid; idx < kCB * 2 * n; idx += kQ) {
      const int c = idx / (2 * n), rem = idx - c * 2 * n;
      stage[c][rem] =
          zl[(static_cast<size_t>(c0 + c) * T + base) * 2 + rem];
    }
    __syncthreads();
    if (tid < kCB) {
      for (int u = 0; u < n; ++u) {
        const float n0 = boundary(stage[tid][2 * u], k0, al1, k1, be1);
        const float n1 = boundary(stage[tid][2 * u + 1], k0, al2, k1, be2);
        k0 = n0;
        k1 = n1;
      }
    }
  }
  if (tid < kCB) {
    carry[tid][0] = k0;
    carry[tid][1] = k1;
  }
  __syncthreads();
}

// The section's FIR part over the tile: xs[c][m] = buf[t * 256 + m] for
// m = 0 .. 257 with buf = [x_tail, x zeroed from `frames` on], then
// vt[c][i] = b0 xs[i+2] + b1 xs[i+1] + b2 xs[i], rounded as eager float32
// ops round. Ends with a __syncthreads().
__device__ void load_fir_tile(float (*vt)[kQ], float (*xs)[kQ + 2],
                              const float* x, const float* x_tail,
                              const float* coefs, int frames, int c0, int t,
                              int B, int tid) {
  const int n = t * kQ + tid;
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
    xs[c][tid + 2] =
        n < frames ? x[static_cast<size_t>(c0 + c) * B + n] : 0.0f;
  }
  if (tid < 2 * kCB) {
    const int c = tid >> 1, e = tid & 1;
    const int m = t * kQ + e - 2;  // index into x of buf[t * 256 + e]
    float val;
    if (m < 0) {
      val = x_tail[(c0 + c) * 2 + e];
    } else {
      val = m < frames ? x[static_cast<size_t>(c0 + c) * B + m] : 0.0f;
    }
    xs[c][e] = val;
  }
  __syncthreads();
  const float b0 = coefs[0], b1 = coefs[1], b2 = coefs[2];
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
    vt[c][tid] = __fadd_rn(
        __fadd_rn(__fmul_rn(b0, xs[c][tid + 2]), __fmul_rn(b1, xs[c][tid + 1])),
        __fmul_rn(b2, xs[c][tid]));
  }
  __syncthreads();
}

// Pass 1. kFir: `in` is x and the tile is the section's FIR part; else `in`
// is v itself. Writes z and zl, and with kFir the new x_tail.
template <bool kFir>
__global__ void __launch_bounds__(kQ)
biquad_product_kernel(const float* __restrict__ in, const float* __restrict__ x_tail,
               const float* __restrict__ coefs, const float* __restrict__ a1p,
               const float* __restrict__ a2p, int frames,
               float* __restrict__ z, float* __restrict__ zl,
               float* __restrict__ new_x_tail, int B) {
  __shared__ Sequences seq;
  __shared__ __align__(16) float vt[kCB][kQ];
  __shared__ float xs[kFir ? kCB : 1][kQ + 2];
  const int tid = threadIdx.x, t = blockIdx.x, c0 = blockIdx.y * kCB;
  if (tid < 32) fill_sequences(seq, *a1p, *a2p, tid);
  if (kFir) {
    load_fir_tile(vt, xs, in, x_tail, coefs, frames, c0, t, B, tid);
    if (t == 0 && tid < 2 * kCB) {
      // buf[frames + e]: the last two valid inputs
      const int c = tid >> 1, k = frames + (tid & 1);
      new_x_tail[(c0 + c) * 2 + (tid & 1)] =
          k < 2 ? x_tail[(c0 + c) * 2 + k]
                : in[static_cast<size_t>(c0 + c) * B + k - 2];
    }
  } else {
    const int n = t * kQ + tid;
    if (whole_tile(t, B)) {
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        vt[c][tid] = in[static_cast<size_t>(c0 + c) * B + n];
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        vt[c][tid] = n < B ? in[static_cast<size_t>(c0 + c) * B + n] : 0.0f;
      }
    }
    __syncthreads();
  }
  const Owner o = owner_of(tid);
  float out[2][4];
  tile_product(vt, seq.gz, o, out);
  if (whole_tile(t, B)) {
    store_product<false>(out, o, z, zl, c0, t, B);
  } else {
    store_product<true>(out, o, z, zl, c0, t, B);
  }
}

// The refine pass's y0 = boundary(z), written over z in y and into
// xs[c][2 ..] for the defect; kTail: z past B reads 0 and y0 there is kept
// out of y.
template <bool kTail>
__device__ __forceinline__ void refine_boundary(float (*xs)[kQ + 2], float* y,
                                                const float (*carry)[2],
                                                float al, float be, int c0,
                                                int t, int B, int tid) {
  const int n = t * kQ + tid;
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
    const size_t at = static_cast<size_t>(c0 + c) * B + n;
    const bool in_row = !kTail || n < B;
    const float y0 =
        boundary(in_row ? y[at] : 0.0f, carry[c][0], al, carry[c][1], be);
    if (in_row) y[at] = y0;
    xs[c][tid + 2] = y0;
  }
}

// Pass 2 of a refined section: y0 = boundary(z) in place, the float64
// defect, and its zero-state product z' into zr / zlr.
__global__ void __launch_bounds__(kQ)
biquad_refine_kernel(const float* __restrict__ x, const float* __restrict__ x_tail,
              const float* __restrict__ coefs, const float* __restrict__ s,
              const float* __restrict__ zl, int frames, float* __restrict__ y,
              float* __restrict__ zr, float* __restrict__ zlr, int B) {
  __shared__ Sequences seq;
  __shared__ __align__(16) float vt[kCB][kQ];
  __shared__ float xs[kCB][kQ + 2];  // the FIR's inputs, then y0 with its past
  __shared__ float stage[kCB][2 * kChunk];
  __shared__ float carry[kCB][2];
  const int tid = threadIdx.x, t = blockIdx.x, c0 = blockIdx.y * kCB;
  const int T = num_tiles(B);
  const float a1f = coefs[4], a2f = coefs[5];
  if (tid < 32) fill_sequences(seq, a1f, a2f, tid);
  load_fir_tile(vt, xs, x, x_tail, coefs, frames, c0, t, B, tid);
  tile_carry(carry, stage, seq, s, zl, c0, t, T, tid);

  const float al = seq.alpha[tid], be = seq.beta[tid];
  const bool whole = whole_tile(t, B);
  if (whole) {
    refine_boundary<false>(xs, y, carry, al, be, c0, t, B, tid);
  } else {
    refine_boundary<true>(xs, y, carry, al, be, c0, t, B, tid);
  }
  if (tid < 2 * kCB) {
    // xs[c][0], xs[c][1] = y0[-2], y0[-1] = carry[c][1], carry[c][0]
    xs[tid >> 1][tid & 1] = carry[tid >> 1][1 - (tid & 1)];
  }
  __syncthreads();
  const double a1 = a1f, a2 = a2f;
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
    const double lag = __dadd_rn(
        __dadd_rn(static_cast<double>(xs[c][tid + 2]),
                  __dmul_rn(a1, static_cast<double>(xs[c][tid + 1]))),
        __dmul_rn(a2, static_cast<double>(xs[c][tid])));
    vt[c][tid] =
        __double2float_rn(__dsub_rn(static_cast<double>(vt[c][tid]), lag));
  }
  __syncthreads();
  const Owner o = owner_of(tid);
  float out[2][4];
  tile_product(vt, seq.gz, o, out);
  if (whole) {
    store_product<false>(out, o, zr, zlr, c0, t, B);
  } else {
    store_product<true>(out, o, zr, zlr, c0, t, B);
  }
}

// The last pass's outputs of one tile (see biquad_finish_kernel); kTail:
// the positions from B on are left alone.
template <bool kRefine, bool kState, bool kTail>
__device__ __forceinline__ void finish_tile(const float* zsrc,
                                            const float (*carry)[2], float al,
                                            float be, int frames, float* y,
                                            float* new_s, int c0, int t, int B,
                                            int tid) {
  const int n = t * kQ + tid;
  if (kTail && n >= B) return;
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
    const size_t at = static_cast<size_t>(c0 + c) * B + n;
    float out = boundary(zsrc[at], carry[c][0], al, carry[c][1], be);
    if (kRefine) out = __fadd_rn(y[at], out);
    y[at] = out;
    if (kState) {
      if (n == frames - 1) new_s[(c0 + c) * 2] = out;
      if (n == frames - 2) new_s[(c0 + c) * 2 + 1] = out;
    }
  }
}

// The last pass. y = boundary(zsrc) along the chain from s over zl; with
// kRefine the chain starts from zero, zsrc is the correction's product and y
// (holding y0) gets it added. With kState it also writes new_s, the state
// after the last valid frame: (y_hist[frames+1], y_hist[frames]) with
// y_hist = [s1, s0, y...].
template <bool kRefine, bool kState>
__global__ void __launch_bounds__(kQ)
biquad_finish_kernel(const float* zsrc, const float* __restrict__ zl,
              const float* __restrict__ s, const float* __restrict__ a1p,
              const float* __restrict__ a2p, int frames, float* y,
              float* __restrict__ new_s, int B) {  // zsrc may be y itself
  __shared__ Sequences seq;
  __shared__ float stage[kCB][2 * kChunk];
  __shared__ float carry[kCB][2];
  const int tid = threadIdx.x, t = blockIdx.x, c0 = blockIdx.y * kCB;
  if (tid < 32) fill_sequences(seq, *a1p, *a2p, tid);
  __syncthreads();
  tile_carry(carry, stage, seq, kRefine ? nullptr : s, zl, c0, t, num_tiles(B),
             tid);
  const float al = seq.alpha[tid], be = seq.beta[tid];
  if (whole_tile(t, B)) {
    finish_tile<kRefine, kState, false>(zsrc, carry, al, be, frames, y, new_s,
                                        c0, t, B, tid);
  } else {
    finish_tile<kRefine, kState, true>(zsrc, carry, al, be, frames, y, new_s,
                                       c0, t, B, tid);
  }
  if (kState && t == 0 && tid < kCB && frames < 2) {
    // y_hist[frames + 1] and y_hist[frames] still lie in the carried state
    const float s0 = s[(c0 + tid) * 2], s1 = s[(c0 + tid) * 2 + 1];
    if (frames == 0) new_s[(c0 + tid) * 2] = s0;
    new_s[(c0 + tid) * 2 + 1] = frames == 0 ? s1 : s0;
  }
}

bool bad_shape(int C, int B) {
  return C <= 0 || B <= 0 || C % kCB != 0 || C / kCB > 65535;
}

}  // namespace

// y (C, B) = the recurrence over v from the state s (C, 2). zl: scratch of
// C * ceil(B / 256) * 2 floats. y must not alias v.
extern "C" int pipe_iir_tiles(const float* v, const float* s, const float* a1,
                              const float* a2, float* y, float* zl, int C,
                              int B, void* stream) {
  if (bad_shape(C, B)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(num_tiles(B), C / kCB);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  biquad_product_kernel<false><<<grid, kQ, 0, st>>>(v, nullptr, nullptr, a1, a2, 0, y,
                                             zl, nullptr, B);
  biquad_finish_kernel<false, false><<<grid, kQ, 0, st>>>(y, zl, s, a1, a2, 0, y,
                                                   nullptr, B);
  return static_cast<int>(cudaGetLastError());
}

// One biquad section over x (C, B), valid to `frames`, from the state
// (x_tail, s), both (C, 2); coefs = [b0, b1, b2, 1, a1, a2] on the card.
// Writes y (C, B), new_x_tail and new_s (C, 2). scratch: C * B +
// 4 * C * ceil(B / 256) floats. No output may alias an input.
extern "C" int pipe_biquad_section(const float* x, const float* x_tail,
                                   const float* s, const float* coefs,
                                   int frames, int refine, float* y,
                                   float* new_x_tail, float* new_s,
                                   float* scratch, int C, int B,
                                   void* stream) {
  if (bad_shape(C, B) || frames < 0 || frames > B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(num_tiles(B), C / kCB);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_last = static_cast<size_t>(C) * num_tiles(B) * 2;
  float* zl = scratch;
  float* zlr = scratch + n_last;
  float* zr = scratch + 2 * n_last;
  const float* a1 = coefs + 4;
  const float* a2 = coefs + 5;
  biquad_product_kernel<true><<<grid, kQ, 0, st>>>(x, x_tail, coefs, a1, a2, frames,
                                            y, zl, new_x_tail, B);
  if (refine) {
    biquad_refine_kernel<<<grid, kQ, 0, st>>>(x, x_tail, coefs, s, zl, frames, y, zr,
                                       zlr, B);
    biquad_finish_kernel<true, true><<<grid, kQ, 0, st>>>(zr, zlr, s, a1, a2, frames,
                                                   y, new_s, B);
  } else {
    biquad_finish_kernel<false, true><<<grid, kQ, 0, st>>>(y, zl, s, a1, a2, frames,
                                                    y, new_s, B);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pipe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
