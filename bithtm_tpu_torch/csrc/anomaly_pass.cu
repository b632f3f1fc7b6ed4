// The anomaly pipeline's two post-processing stages over a whole (T, B)
// series in one launch each, for NVIDIA Hopper (sm_90a): the anomaly
// likelihood and the seasonal windowed z-score.
//
// Stands for the JAX package's anomaly_likelihood_update and
// seasonal_zscore_update (bithtm_tpu/encoders.py:171, :255), which the JAX
// examples and seasonal_zscore (:291) run as a lax.scan that XLA compiles.
// The TPU package has no Pallas kernel for them. Plain PyTorch versions:
// bithtm_tpu_torch/encoders.py (anomaly_likelihood_steps_ref and
// seasonal_zscore_steps_ref: a Python loop of the update, some 70 and 58
// torch calls a step). T = 1 is the streaming update.
//
// anomaly_likelihood, per stream b and step t, from the state (the (W,)
// ring of raw scores, pos, count, short_mean) and the score s:
//   ring[pos] = s;  pos' = (pos + 1) % W;  count' = min(count + 1, W)
//   short'    = fmaf(s, 1 - m, m * (count > 0 ? short : s))  (one rounding
//               of the sum, m * prev rounded alone: the port's _fma_f32)
//   est       = the slots whose age (pos' - 1 - slot) mod W is in
//               [R, count'); n = max(|est|, 1)
//   mean      = sum(est ? ring : 0) / n
//   var       = sum(est ? (ring - mean)^2 : 0) / n
//   z         = (short' - mean) / sqrt(max(var, 1e-8))
//   L         = count' >= R + 10 ? 0.5 * (1 + erff(z / f32(sqrt 2))) : 0.5
// seasonal_zscore, per stream b and step t = pos, from the state (the
// (L,) ring of raw values, L = lags * P, the (W,) ring of residuals, pos)
// and the value v:
//   med = the median of lag[(t - i*P) mod L], i = 1..k, k = L / P (the
//         element of rank (k - 1) / 2: exact, one of the values)
//   r   = t >= L ? v - med : 0
//   s1, s2 = the sums of resid and resid^2 over the slots below min(t, W)
//   mean = s1 / n, n = clamp(t, 1, W);  var = max(s2 / n - mean^2, eps)
//   z    = t >= L + W ? (r - mean) / sqrt(var) : 0
//   lag[t mod L] = v;  resid[t mod W] = r;  pos' = t + 1
// Every product, sum, quotient and root rounds where the plain version's
// op rounds it: __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn and
// one __fmaf_rn for the EMA, so that nvcc contracts nothing (s2 / n -
// mean^2 cancels; one FMA there would move z). The ring, pos, count,
// short_mean, lag and resid therefore equal the plain version's bit for
// bit. Only the two sums of each step run in another order: each lane adds
// its slots lane, lane + 32, ... in turn, in blocks of kBlock slots each
// summed from zero and then added to the lane's total, and the warp adds
// the 32 totals by a butterfly of shuffles (xor 16, 8, 4, 2, 1). One
// running sum a lane (625 slots a lane at W = 20,000) moved L by 2.2 times
// the tolerance against JAX's scan, where torch's and XLA's tree sums stay
// within it; the blocks bring it level with torch's. A compensated sum
// (Fast2Sum a slot) was as accurate but cost 28% of the likelihood's time
// at the benchmark's shapes (scripts/grow_variants.py, "plain_sums"). L
// and z differ from the plain version's by the sums' rounding (and erff
// from torch.erf on the CPU), within the tolerances of
// tests/test_torch_encoders.py, which models these sums in numpy against
// JAX's scan.
//
// Schedule. A warp takes a stream and walks T in order, a block a warp (the
// streams in grid x: any B; four warps a block, one on each of an SM's
// schedulers, took 21% longer at the benchmark's shapes than one, their
// shuffles and shared loads sharing the SM's pipe). A stream's rings live
// in dynamic shared memory ("smem") while they fit a block; past it the
// warp works on the output state's rings in global memory ("global"), the
// same code on other pointers. A lane owns the slots lane, lane + 32, ...
// of a residual or score ring: it alone reads and writes them, so those
// rings need no barrier; the lag ring, read by every lane for the median,
// takes a __syncwarp between its reads and its write and after the write.
// The series is read 32 steps at a time, lane i loading step t0 + i while
// the warp works through the 32 steps before (each step's value taken by a
// shuffle), and the outputs leave the same way, 32 steps a store. The input
// series may be strided (an expanded stream axis has stride 0) and float32
// or float64 (rounded to float32 as it is read, as the plain version's
// conversion rounds it). A null input state is a fresh one (zeros), so
// that a series from the start launches no fill.
//
// Bound. The likelihood does about 6 W float32 operations a stream-step
// (the masked sum, the difference, its square and the masked sum again):
// 1,440 x 256 x 6 x 300 = 663 M at the anomaly benchmark's shapes, 0.0099
// ms at the H100's 67 TFLOP/s, above its bytes (the series in and out
// and the state: 3.6 MB, 0.0011 ms); the z-score about 5 W (96):
// 0.0026 ms. Both are far from either: each step's sums wait on a chain
// of shuffles and divisions, and the steps of a stream run in turn. Every
// step's sums are independent of the others' (the rings' contents at each
// step follow from the inputs; only the EMA chains), which a later design
// can spread over the steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "launch.cuh"

namespace {

constexpr int kWarps = 1;  // streams a block (ops/kernels.py ANOMALY_WARPS)
constexpr int kBlock = 16;  // slots a lane sums alone before its total
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSqrt2 = 1.4142135623730951f;  // f32(sqrt 2), as torch's

// The sum of the warp's 32 partials, equal in every lane: lane i adds the
// partial of lane i ^ d for d = 16, 8, 4, 2, 1 (float addition commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Two such sums at once, their shuffles interleaved.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float oa = __shfl_xor_sync(kFull, a, d);
    const float ob = __shfl_xor_sync(kFull, b, d);
    a = __fadd_rn(a, oa);
    b = __fadd_rn(b, ob);
  }
}

// The median of three lags, the middle value (one of them: exact).
__device__ __forceinline__ float median3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// The lag of rank (k - 1) / 2 among lag[(tl - a * P) mod L], a = 1..k:
// the first whose count of smaller lags is at most that rank and whose
// count of lags not greater is above it (one of the values: exact). Three
// lags (every shipped configuration) take median3.
__device__ __forceinline__ float median(const float* lag, int tl, int L,
                                        int P, int k) {
  auto at = [&](int a) {
    const int i = tl - a * P;
    return lag[i < 0 ? i + L : i];
  };
  if (k == 3) return median3(at(1), at(2), at(3));
  const int rank = (k - 1) / 2;
  for (int a = 1; a <= k; ++a) {
    const float xa = at(a);
    int lt = 0, le = 0;
    for (int c = 1; c <= k; ++c) {
      const float xc = at(c);
      lt += xc < xa;
      le += xc <= xa;
    }
    if (lt <= rank && rank < le) return xa;
  }
  return 0.0f;
}

// The series x (T, B) at (t, b), strides ts and bs in elements, float32 or
// float64, rounded to float32.
template <typename In>
__device__ __forceinline__ float series_at(const In* x, long long ts,
                                           long long bs, int t, long long b) {
  return static_cast<float>(x[(long long)t * ts + b * bs]);
}

// The series' values of steps t0 + lane (0 past T): a lane each.
template <typename In>
__device__ __forceinline__ float series_chunk(const In* x, long long ts,
                                              long long bs, int t0, int T,
                                              long long b, int lane) {
  const int t = t0 + lane;
  return t < T ? series_at(x, ts, bs, t, b) : 0.0f;
}

// x mod n in [0, n) for n >= 1, as torch.remainder gives it.
__device__ __forceinline__ int wrap(int x, int n) {
  const int m = x % n;
  return m < 0 ? m + n : m;
}

template <bool kShared, typename In>
__global__ void __launch_bounds__(kThreads) likelihood_kernel(
    const float* __restrict__ ring_in, const int* __restrict__ pos_in,
    const int* __restrict__ count_in, const float* __restrict__ short_in,
    const In* __restrict__ x, long long ts, long long bs,
    float* __restrict__ ring_out, int* __restrict__ pos_out,
    int* __restrict__ count_out, float* __restrict__ short_out,
    float* __restrict__ lik, int T, int B, int W, int R, float m,
    float one_minus) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;
  float* ring = kShared ? smem + (size_t)warp * W : ring_out + b * W;
  for (int j = lane; j < W; j += 32)
    ring[j] = ring_in ? ring_in[b * W + j] : 0.0f;
  int pos = wrap(pos_in ? pos_in[b] : 0, W);
  int count = count_in ? count_in[b] : 0;
  float sm = short_in ? short_in[b] : 0.0f;
  const int lo = R > 0 ? R : 0;  // the est ages are [max(R, 0), count')
  const int slots = lane < W ? (W - lane + 31) >> 5 : 0;  // lane's slots

  float next = series_chunk(x, ts, bs, 0, T, b, lane);
  for (int t0 = 0; t0 < T; t0 += 32) {
    const float chunk = next;
    next = series_chunk(x, ts, bs, t0 + 32, T, b, lane);
    const int steps = T - t0 < 32 ? T - t0 : 32;
    float mine = 0.0f;
    for (int i = 0; i < steps; ++i) {
      const float s = __shfl_sync(kFull, chunk, i);
      if ((pos & 31) == lane) ring[pos] = s;
      const int np = pos + 1 == W ? 0 : pos + 1;
      const int nc = count < W - 1 ? count + 1 : W;
      sm = __fmaf_rn(s, one_minus, __fmul_rn(m, count > 0 ? sm : s));
      const int n = nc - lo;
      const float nf = (float)(n > 1 ? n : 1);
      // the age of slot lane; each next slot of the lane is 32 younger
      // (mod W; a lane holds one slot where W < 32)
      int a0 = np - 1 - lane;
      a0 += a0 < 0 ? W : 0;
      float acc = 0.0f;
      for (int k0 = 0, age = a0; k0 < slots; k0 += kBlock) {
        const int k1 = min(k0 + kBlock, slots);
        float blk = 0.0f;
#pragma unroll 4
        for (int k = k0; k < k1; ++k) {
          blk = __fadd_rn(blk, age >= R && age < nc ? ring[lane + 32 * k]
                                                    : 0.0f);
          age -= 32;
          age += age < 0 ? W : 0;
        }
        acc = __fadd_rn(acc, blk);
      }
      const float mean = __fdiv_rn(warp_sum(acc), nf);
      float sq = 0.0f;
      for (int k0 = 0, age = a0; k0 < slots; k0 += kBlock) {
        const int k1 = min(k0 + kBlock, slots);
        float blk = 0.0f;
#pragma unroll 4
        for (int k = k0; k < k1; ++k) {
          const float d = __fsub_rn(ring[lane + 32 * k], mean);
          blk = __fadd_rn(blk, age >= R && age < nc ? __fmul_rn(d, d) : 0.0f);
          age -= 32;
          age += age < 0 ? W : 0;
        }
        sq = __fadd_rn(sq, blk);
      }
      const float var = __fdiv_rn(warp_sum(sq), nf);
      const float sd = __fsqrt_rn(var < 1e-8f ? 1e-8f : var);
      const float z = __fdiv_rn(__fsub_rn(sm, mean), sd);
      const float L =
          nc >= R + 10
              ? __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fdiv_rn(z, kSqrt2))))
              : 0.5f;
      if (lane == i) mine = L;
      pos = np;
      count = nc;
    }
    if (lane < steps) lik[(long long)(t0 + lane) * B + b] = mine;
  }
  if (kShared)
    for (int j = lane; j < W; j += 32) ring_out[b * W + j] = ring[j];
  if (lane == 0) {
    pos_out[b] = pos;
    count_out[b] = count;
    short_out[b] = sm;
  }
}

template <bool kShared, typename In>
__global__ void __launch_bounds__(kThreads) zscore_kernel(
    const float* __restrict__ lag_in, const float* __restrict__ resid_in,
    const int* __restrict__ pos_in, const In* __restrict__ x, long long ts,
    long long bs, float* __restrict__ lag_out, float* __restrict__ resid_out,
    int* __restrict__ pos_out, float* __restrict__ zout, int T, int B, int L,
    int W, int P, float eps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;
  float* lag = kShared ? smem + (size_t)warp * (L + W) : lag_out + b * L;
  float* resid = kShared ? lag + L : resid_out + b * W;
  for (int j = lane; j < L; j += 32)
    lag[j] = lag_in ? lag_in[b * L + j] : 0.0f;
  for (int j = lane; j < W; j += 32)
    resid[j] = resid_in ? resid_in[b * W + j] : 0.0f;
  __syncwarp();
  int t = pos_in ? pos_in[b] : 0;
  int tl = wrap(t, L), tw = wrap(t, W);
  const int k = L / P;  // the lags of the median
  const int slots = lane < W ? (W - lane + 31) >> 5 : 0;  // lane's slots

  float next = series_chunk(x, ts, bs, 0, T, b, lane);
  for (int t0 = 0; t0 < T; t0 += 32) {
    const float chunk = next;
    next = series_chunk(x, ts, bs, t0 + 32, T, b, lane);
    const int steps = T - t0 < 32 ? T - t0 : 32;
    float mine = 0.0f;
    for (int i = 0; i < steps; ++i) {
      const float v = __shfl_sync(kFull, chunk, i);
      float r = 0.0f;
      if (t >= L) r = __fsub_rn(v, median(lag, tl, L, P, k));
      const int live = t < W ? t : W;
      const int n = t < 1 ? 1 : live;
      const float nf = (float)n;
      float s1 = 0.0f, s2 = 0.0f;
      for (int q0 = 0; q0 < slots; q0 += kBlock) {
        const int q1 = min(q0 + kBlock, slots);
        float b1 = 0.0f, b2 = 0.0f;
#pragma unroll 4
        for (int q = q0; q < q1; ++q) {
          const int j = lane + 32 * q;
          const float e = resid[j];
          b1 = __fadd_rn(b1, j < live ? e : 0.0f);
          b2 = __fadd_rn(b2, j < live ? __fmul_rn(e, e) : 0.0f);
        }
        s1 = __fadd_rn(s1, b1);
        s2 = __fadd_rn(s2, b2);
      }
      warp_sum2(s1, s2);
      const float mean = __fdiv_rn(s1, nf);
      const float d = __fsub_rn(__fdiv_rn(s2, nf), __fmul_rn(mean, mean));
      const float var = d < eps ? eps : d;
      const float z =
          t >= L + W ? __fdiv_rn(__fsub_rn(r, mean), __fsqrt_rn(var)) : 0.0f;
      if (lane == i) mine = z;
      __syncwarp();  // every lane has read its lags
      if (lane == 0) lag[tl] = v;
      if ((tw & 31) == lane) resid[tw] = r;
      __syncwarp();
      ++t;
      tl = tl + 1 == L ? 0 : tl + 1;
      tw = tw + 1 == W ? 0 : tw + 1;
    }
    if (lane < steps) zout[(long long)(t0 + lane) * B + b] = mine;
  }
  if (kShared) {
    for (int j = lane; j < L; j += 32) lag_out[b * L + j] = lag[j];
    for (int j = lane; j < W; j += 32) resid_out[b * W + j] = resid[j];
  }
  if (lane == 0) pos_out[b] = t;
}

// Launches kernel over B streams, kWarps a block, with `floats` shared
// floats a stream where they fit a block (kShared), after the opt-in.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool shared, int floats, int B, cudaStream_t stream,
           Args... args) {
  const size_t smem = shared ? (size_t)kWarps * floats * sizeof(float) : 0;
  if (int err = bithtm::allow_shared(
          kernel, smem > 48 * 1024 ? bithtm::kMaxShared : smem))
    return err;
  const long long blocks = ((long long)B + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool fits(long long floats) {
  return (long long)kWarps * floats * (long long)sizeof(float) <=
         (long long)bithtm::kMaxShared;
}

}  // namespace

// The likelihood over a (T, B) series x (float32, or float64 with x_f64;
// element strides x_ts, x_bs) from the state scores_in (B, W) float32,
// pos_in and count_in (B,) int32, short_in (B,) float32 (all null: a
// fresh state) into new tensors scores_out, pos_out, count_out, short_out
// and lik (T, B) float32; R = exclude_recent, m = f32(short_momentum) and
// one_minus = f32(1 - short_momentum). Launches on the given stream of the
// given device and returns cudaGetLastError() after the launch.
extern "C" int anomaly_likelihood(
    const float* scores_in, const int* pos_in, const int* count_in,
    const float* short_in, const void* x, long long x_ts, long long x_bs,
    int x_f64, float* scores_out, int* pos_out, int* count_out,
    float* short_out, float* lik, int T, int B, int W, int R, float m,
    float one_minus, int device, void* stream) {
  if (T < 0 || B < 0 || W < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool shared = fits(W);
  auto run = [&](auto k, auto in) {
    return launch(k, shared, W, B, s, scores_in, pos_in, count_in, short_in,
                  in, x_ts, x_bs, scores_out, pos_out, count_out, short_out,
                  lik, T, B, W, R, m, one_minus);
  };
  const float* xf = static_cast<const float*>(x);
  const double* xd = static_cast<const double*>(x);
  if (shared)
    return x_f64 ? run(likelihood_kernel<true, double>, xd)
                 : run(likelihood_kernel<true, float>, xf);
  return x_f64 ? run(likelihood_kernel<false, double>, xd)
               : run(likelihood_kernel<false, float>, xf);
}

// The seasonal z-score over a (T, B) series x (as above) from the state
// lag_in (B, L), resid_in (B, W) float32, pos_in (B,) int32 (all null: a
// fresh state) into new tensors lag_out, resid_out, pos_out and z (T, B)
// float32, period P (1 <= P <= L), eps = f32(eps). Launches on the given
// stream of the given device and returns cudaGetLastError().
extern "C" int seasonal_zscore(
    const float* lag_in, const float* resid_in, const int* pos_in,
    const void* x, long long x_ts, long long x_bs, int x_f64,
    float* lag_out, float* resid_out, int* pos_out, float* z, int T, int B,
    int L, int W, int P, float eps, int device, void* stream) {
  if (T < 0 || B < 0 || W < 1 || P < 1 || L < P)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool shared = fits((long long)L + W);
  auto run = [&](auto k, auto in) {
    return launch(k, shared, L + W, B, s, lag_in, resid_in, pos_in, in, x_ts,
                  x_bs, lag_out, resid_out, pos_out, z, T, B, L, W, P, eps);
  };
  const float* xf = static_cast<const float*>(x);
  const double* xd = static_cast<const double*>(x);
  if (shared)
    return x_f64 ? run(zscore_kernel<true, double>, xd)
                 : run(zscore_kernel<true, float>, xf);
  return x_f64 ? run(zscore_kernel<false, double>, xd)
               : run(zscore_kernel<false, float>, xf);
}
