// One envelope-driven dynamics op (compressor, limiter or noise gate) over a
// (C, B) float32 block in one launch, for Hopper (sm_90a): what
// ops/dynamics.py::envelope_block and the op's gain compute, line for line.
//
// Replaces no TPU kernel. The JAX package runs these recurrences as
// lax.associative_scan, which XLA fuses into one program; the port's plain
// version runs them as prefix-doubling scans of eager torch ops (~280
// launches an op and block at 9,408 frames). This kernel is that work in one
// launch.
//
// What bounds it on an H100: the bytes are x read once and y written once,
// 8 C B bytes (4.8 MB at (64, 9408): 1.44 us at 3.35 TB/s), and the flops
// are few. The real limit is the latency of three dependent recurrences
// over each row. So every intermediate stays on chip (registers and shared
// memory), and each recurrence is split so that only short chains are
// walked in order:
//
//   Grid: one CUDA block per channel. The block walks its row in super-tiles
//   of kTile frames, in order, with the carries of the three recurrences in
//   shared memory: the loop replaces the sequential grid, and any C >= 1 and
//   B >= 1 work (a partial last tile is read as zeros past B and never
//   stored; the recurrences are causal, so what lies past B changes no
//   output before it).
//
//   Within a super-tile a thread holds kPer consecutive frames in registers,
//   and each recurrence takes three steps:
//     1. a thread-local walk from zero to the run's associative pair
//        (r^k, m) or (a^k, u);
//     2. a block-wide exclusive scan of the pairs (warp shuffles, then one
//        shared-memory step across warps) applied to the super-tile's
//        entering value;
//     3. a thread-local walk of the run from that entering value.
//
// The three recurrences (ops/dynamics.py::envelope_block):
//   raw[n] = max(v[n], r raw[n-1]),   v = |x| zeroed from `frames` on,
//            raw[-1] = env0[0], r = exp(-1000 / (max(release_ms, 1e-3) sr));
//   y[n]   = ca_hi y[n-1] + um[n],    um + ue = oma raw exactly,
//            y[-1] = env0[1], oma = -expm1(-1000 / (max(attack_ms, 1e-3) sr)),
//            ca_hi + ca_lo = 1 - oma exactly;
//   dy[n]  = ca_hi dy[n-1] + res[n], dy[-1] = 0, with the residual of y
//            against the accurate recurrence formed by error-free transforms
//            res = (s - y) + (pe + se + ue) + ca_lo y[n-1],
//            p + pe = ca_hi y[n-1], s + se = p + um; res[0] += ca_hi env0_lo.
// The follower is walked in float64 (its pairs, its walk and its carry
// between super-tiles) and rounded once a frame to float32: a float32 walk
// compounds one rounding of r a frame over a decay, and the plain version's
// powers r^(2^j) compound theirs, up to 3e-5 over a decay of one block.
// The smoothed envelope is env = y + dy, and the gain follows
// ops/dynamics.py::compressor_gain or NoiseGate._gain (a template argument).
// y[n-1] at a thread's first frame is its neighbour's last y as stored, so
// the residual is that of the sequence actually kept, and a super-tile's
// carries are its last raw, y and dy: the result is the whole-block
// computation. Across blocks the dd carry (env, env_lo) is the plain
// version's: (raw, eh) and el from two_sum(y, dy) at the last valid frame.
//
// The error-free transforms use fmaf / __fadd_rn / __fmul_rn, which nvcc
// never contracts into other FMAs. The coefficients and the gain are the
// float32 operations that torch's CUDA kernels run for the plain version,
// in its order: the exponent as a reciprocal and a product, expf and
// expm1f, log10f and powf, a division by a scalar as a product by its
// float32 reciprocal. So on the card both versions derive the same
// coefficients, and they differ only by the order of the scans' roundings.
//
// Launch contract: the kernel runs on the given stream, allocates nothing,
// and reads every param from the live 0-d tensors on the card, so no host
// sync is needed; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                // frames a thread holds
constexpr int kTile = kThreads * kPer;  // frames a super-tile
constexpr int kStride = kPer + 1;       // padded run in shared memory
constexpr unsigned kFull = 0xffffffffu;

// A run's effect on the value entering it: out = apply(pair, in).
template <class T>
struct EnvelopePair {
  T a, v;
};

// raw[n] = max(v[n], r raw[n-1]): a run is (r^k, its value from 0), in
// float64 (see the kernel).
struct EnvelopeMaxDecay {
  using T = double;
  __device__ __forceinline__ static EnvelopePair<T> combine(EnvelopePair<T> l,
                                                            EnvelopePair<T> r) {
    return {__dmul_rn(l.a, r.a), fmax(r.v, __dmul_rn(l.v, r.a))};
  }
  __device__ __forceinline__ static T apply(EnvelopePair<T> p, T e) {
    return fmax(p.v, __dmul_rn(p.a, e));
  }
};

// y[n] = a y[n-1] + u[n]: a run is (a^k, its value from 0).
struct EnvelopeAffine {
  using T = float;
  __device__ __forceinline__ static EnvelopePair<T> combine(EnvelopePair<T> l,
                                                            EnvelopePair<T> r) {
    return {__fmul_rn(l.a, r.a), fmaf(r.a, l.v, r.v)};
  }
  __device__ __forceinline__ static T apply(EnvelopePair<T> p, T e) {
    return fmaf(p.a, e, p.v);
  }
};

__device__ __forceinline__ void envelope_two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// The value entering this thread's run: the super-tile's entering value
// `carry` taken through the runs of every thread before it. `tot` holds one
// pair a warp; one __syncthreads inside.
template <class Op, class T = typename Op::T>
__device__ __forceinline__ T envelope_entering(EnvelopePair<T> p, T carry,
                                               EnvelopePair<T>* tot, int lane,
                                               int warp) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    EnvelopePair<T> o;
    o.a = __shfl_up_sync(kFull, p.a, d);
    o.v = __shfl_up_sync(kFull, p.v, d);
    if (lane >= d) p = Op::combine(o, p);
  }
  if (lane == 31) tot[warp] = p;
  __syncthreads();
  T e = carry;
  for (int w = 0; w < warp; ++w) e = Op::apply(tot[w], e);
  EnvelopePair<T> before;
  before.a = __shfl_up_sync(kFull, p.a, 1);
  before.v = __shfl_up_sync(kFull, p.v, 1);
  return lane == 0 ? e : Op::apply(before, e);
}

// float32 exponent -1000 / (max(ms, 1e-3) sr), as torch forms it from the
// 0-d param: (t sr)^-1 * -1000.
__device__ __forceinline__ float envelope_exponent(float ms, float sr) {
  return __fmul_rn(__frcp_rn(__fmul_rn(fmaxf(ms, 1e-3f), sr)), -1000.0f);
}

__device__ __forceinline__ float envelope_level_db(float env) {
  return __fmul_rn(20.0f, log10f(fmaxf(env, 1e-8f)));
}

// compressor_gain(env, threshold_db, ratio, makeup_db); ratio may be inf
__device__ __forceinline__ float envelope_compressor_gain(float env, float thr,
                                                          float slope,
                                                          float makeup) {
  const float over = fmaxf(__fsub_rn(envelope_level_db(env), thr), 0.0f);
  const float gain_db = __fadd_rn(__fmul_rn(-over, slope), makeup);
  return powf(10.0f, __fmul_rn(gain_db, 0.05f));
}

template <bool kGate>
__global__ void __launch_bounds__(kThreads)
envelope_block_kernel(const float* __restrict__ x, const float* __restrict__ env0,
                      const float* __restrict__ env0_lo,
                      const float* __restrict__ attack_ms,
                      const float* __restrict__ release_ms,
                      const float* __restrict__ g0, const float* __restrict__ g1,
                      const float* __restrict__ g2, float sr, int frames,
                      float* __restrict__ y_out, float* __restrict__ new_env,
                      float* __restrict__ new_lo, int B) {
  __shared__ float tile[kThreads * kStride];
  __shared__ EnvelopePair<double> tot_raw[kWarps];
  __shared__ EnvelopePair<float> tot[2][kWarps];
  __shared__ float last_y[kWarps];
  __shared__ double carry_raw;  // raw leaving the previous super-tile
  __shared__ float carry[2];    // y and dy leaving it

  const int c = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* xr = x + static_cast<size_t>(c) * B;
  float* yr = y_out + static_cast<size_t>(c) * B;

  // the float32 coefficient r, applied in float64 (below)
  const double r = expf(envelope_exponent(*release_ms, sr));
  const float oma = -expm1f(envelope_exponent(*attack_ms, sr));
  const float ca_hi = __fsub_rn(1.0f, oma);
  const float ca_lo = __fsub_rn(__fsub_rn(1.0f, ca_hi), oma);
  double r_run = 1.0;  // r^kPer
  float ca_run = 1.0f;  // ca_hi^kPer
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    r_run = __dmul_rn(r_run, r);
    ca_run = __fmul_rn(ca_run, ca_hi);
  }
  const float thr = *g0;
  // gate: the closed gain 10^(-range/20); compressor: the slope 1 - 1/ratio
  const float k1 = kGate ? powf(10.0f, __fmul_rn(-*g1, 0.05f))
                         : __fsub_rn(1.0f, __frcp_rn(fmaxf(*g1, 1.0f)));
  const float makeup = kGate ? 0.0f : *g2;
  const int last = min(max(frames - 1, 0), B - 1);

  if (tid == 0) {
    carry_raw = env0[2 * c];
    carry[0] = env0[2 * c + 1];
    carry[1] = 0.0f;
  }
  for (int base = 0; base < B; base += kTile) {
    __syncthreads();  // the previous super-tile's readers are done
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid, n = base + e;
      tile[(e / kPer) * kStride + e % kPer] = n < B ? xr[n] : 0.0f;
    }
    __syncthreads();
    const double raw_in = carry_raw;
    const float y_in = carry[0], dy_in = carry[1];
    const int n0 = base + tid * kPer;  // this thread's first frame
    float* run = tile + tid * kStride;

    // 1. the release follower, walked in float64 and rounded once a frame:
    // in float32 a decay of k frames compounds k roundings of r (the plain
    // version's powers r^(2^j) compound theirs), 3e-5 over one block's
    // decay, as much as the whole cell's limit allows the strip
    float raw[kPer];
    EnvelopePair<double> q = {r_run, 0.0};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      raw[j] = n0 + j < frames ? fabsf(run[j]) : 0.0f;
      q.v = fmax(static_cast<double>(raw[j]), __dmul_rn(r, q.v));
    }
    double walk = envelope_entering<EnvelopeMaxDecay>(q, raw_in, tot_raw, lane, warp);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      walk = fmax(static_cast<double>(raw[j]), __dmul_rn(r, walk));
      raw[j] = __double2float_rn(walk);
      if (n0 + j == last) new_env[2 * c] = raw[j];
    }
    if (tid == kThreads - 1) carry_raw = walk;

    // 2. the attack one-pole on um, the rounded oma raw (ue its error)
    float um[kPer], ue[kPer], y[kPer];
    EnvelopePair<float> p = {ca_run, 0.0f};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      um[j] = __fmul_rn(oma, raw[j]);
      ue[j] = fmaf(oma, raw[j], -um[j]);
      p.v = fmaf(ca_hi, p.v, um[j]);
    }
    float prev = envelope_entering<EnvelopeAffine>(p, y_in, tot[0], lane, warp);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      y[j] = fmaf(ca_hi, prev, um[j]);
      prev = y[j];
    }
    if (lane == 31) last_y[warp] = y[kPer - 1];
    if (tid == kThreads - 1) carry[0] = y[kPer - 1];
    __syncthreads();

    // 3. the refinement: the residual of y, filtered once more (in um)
    float yp = __shfl_up_sync(kFull, y[kPer - 1], 1);
    if (lane == 0) yp = warp == 0 ? y_in : last_y[warp - 1];
    p = {ca_run, 0.0f};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float ym = j == 0 ? yp : y[j - 1];
      const float pr = __fmul_rn(ca_hi, ym);
      const float pe = fmaf(ca_hi, ym, -pr);
      float s, se;
      envelope_two_sum(pr, um[j], s, se);
      float res = __fadd_rn(__fadd_rn(__fsub_rn(s, y[j]),
                                      __fadd_rn(__fadd_rn(pe, se), ue[j])),
                            __fmul_rn(ca_lo, ym));
      if (n0 + j == 0) res = __fadd_rn(res, __fmul_rn(ca_hi, env0_lo[c]));
      um[j] = res;
      p.v = fmaf(ca_hi, p.v, res);
    }
    prev = envelope_entering<EnvelopeAffine>(p, dy_in, tot[1], lane, warp);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      um[j] = fmaf(ca_hi, prev, um[j]);  // dy
      prev = um[j];
    }
    if (tid == kThreads - 1) carry[1] = um[kPer - 1];

    // 4. the gain on env = y + dy, y = x g over all B frames, and the carry
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float env = __fadd_rn(y[j], um[j]);
      float g;
      if (kGate) {
        g = envelope_level_db(env) >= thr ? 1.0f : k1;
      } else {
        g = envelope_compressor_gain(env, thr, k1, makeup);
      }
      run[j] = __fmul_rn(run[j], g);
      if (n0 + j == last) {
        float eh, el;
        envelope_two_sum(y[j], um[j], eh, el);
        new_env[2 * c + 1] = eh;
        new_lo[c] = el;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid, n = base + e;
      if (n < B) yr[n] = tile[(e / kPer) * kStride + e % kPer];
    }
  }
}

}  // namespace

// One envelope op over x (C, B), valid to `frames`, from the carried env
// (C, 2) and env_lo (C,). attack_ms, release_ms and the gain's params are
// 0-d tensors on the card: gate != 0 takes g0 = threshold_db, g1 = range_db
// (g2 unread); else g0 = threshold_db, g1 = ratio, g2 = makeup_db. Writes
// y (C, B), new_env (C, 2) and new_lo (C,). No output may alias an input.
extern "C" int pipe_envelope_block(const float* x, const float* env,
                                   const float* env_lo, const float* attack_ms,
                                   const float* release_ms, const float* g0,
                                   const float* g1, const float* g2,
                                   float sample_rate, int frames, int gate,
                                   float* y, float* new_env, float* new_lo,
                                   int C, int B, void* stream) {
  if (C <= 0 || B <= 0 || frames < 0 || frames > B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gate) {
    envelope_block_kernel<true><<<C, kThreads, 0, st>>>(
        x, env, env_lo, attack_ms, release_ms, g0, g1, g2, sample_rate, frames,
        y, new_env, new_lo, B);
  } else {
    envelope_block_kernel<false><<<C, kThreads, 0, st>>>(
        x, env, env_lo, attack_ms, release_ms, g0, g1, g2, sample_rate, frames,
        y, new_env, new_lo, B);
  }
  return static_cast<int>(cudaGetLastError());
}
