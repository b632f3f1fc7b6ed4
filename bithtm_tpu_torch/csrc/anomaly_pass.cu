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
// mean^2 cancels; one FMA there would move z). The new state therefore
// equals the plain version's bit for bit. Only the two sums of each step
// run in another order, one fixed by W (and R) alone, never by T, B or
// where a step falls in a launch, so that a loop of T = 1 updates equals
// one call over the series bit for bit. L and z differ from the plain
// version's by the sums' rounding (and erff from torch.erf on the CPU),
// within the tolerances of tests/test_torch_encoders.py, which models each
// order in numpy against JAX's scan at the largest W its path takes.
//
// The steps in parallel. A step's window follows from the inputs alone:
// after step t of a launch writes, the likelihood's ring holds at age a
// the score of step t - a, from this launch's series where t - a >= 0 and
// from the carried ring (slot (pos + t - a) mod W) before it; before step
// t writes, the z-score's residual window holds the residuals of the
// steps [t - W, t - 1], each from this launch where it falls in it (r
// from v and its k lags, themselves the series' or the carried lag
// ring's) and from the carried residual ring before it. Only the
// likelihood's EMA chains one step to the next, and it is one rounding
// pair a step, which a scan of the affine map would round otherwise.
// So the steps of a stream run side by side, in tiles, each step's window
// rebuilt from the inputs. Two paths, chosen by W alone (ops/kernels.py
// `_steps`):
//   "lane" (W <= kLaneWindow): a block a stream walks its tiles of up to
//     256 steps (kLaneWarps warps, fewer where T is shorter), a thread a
//     step. Shared memory holds the W - 1 (likelihood; W for the
//     z-score) values before the tile and the tile's own, rebuilt from
//     the series and the carried rings for each tile (the z-score's
//     residuals from v and its lags). A thread adds its step's window in
//     age order (tree_sum), the threads of a warp on consecutive steps
//     reading consecutive words: no shuffles and no bank conflicts, and
//     the divisions, the root and erff paid once a step. Where T is at
//     most kWideSteps (the streaming update is T = 1), one thread's serial
//     sum would be the whole launch's time: a warp takes a step instead,
//     its lanes summing the window's runs of 64 terms side by side and
//     adding them in the same order (tree_sum_warp).
//   "warp" (W past it): a warp a step, a stream's tiles of up to
//     kWarpSteps steps spread over gridDim.y blocks so that some
//     kFillBlocks blocks fill the card (a long window on a few streams
//     has few steps). Each lane reads its terms from the inputs (the
//     series, the carried rings, the z-score's residuals from v and its
//     lags): lane l adds the ages l, l + 32, ... in tree_sum's order and
//     the warp adds the 32 totals by a butterfly of shuffles (xor 16, 8,
//     4, 2, 1).
// The likelihood's block holds one more warp, the producer, that runs
// the EMA, the one chain from step to step (some 8 cycles a step): on the
// lane path its lane 0 from the tile in shared memory, beside the other
// warps' sums, which read the tile's short means after a barrier; on the
// warp path the whole warp, 32 scores a round, from step 0 through its
// block's tiles. A short series' warps (a warp a step, T <= kWideSteps)
// each run the tile's few steps of it themselves, which saves the
// producer's barrier. The z-score has no chain and no producer.
//
// tree_sum: a tree of fours, each sum of four taken from zero in turn
// (blocks of 4 terms, of 4 blocks, ... six levels, 4,096 terms), the
// trees of 4,096 added in turn. One running sum of blocks of 16 a thread
// moved L by 4x the tolerance at W = 60,000 in the numpy model, and a
// tree of sixteens left the z-score at W = 20 at the tolerance's edge
// (its s2 / n - mean^2 cancels); the fours keep both within it at every W
// tried (20 to 60,000). Where a step's window holds fewer slots than W
// (the first steps of a stream), the missing terms are zeros, which
// change no partial sum: the sums stop at the last one.
//
// The input series may be strided (an expanded stream axis has stride 0)
// and float32 or float64 (rounded to float32 as it is read, as the plain
// version's conversion rounds it). A null input state is a fresh one
// (zeros), so that a series from the start launches no fill.
//
// Bound: chip_smoke.py `stage_ops` counts the float32 operations the
// function needs over the slots that enter its sums in a run (4 a slot of
// the likelihood's estimate, 3 a live residual, and those of each step
// around them): 366 M for the likelihood and 107 M for the z-score at the
// anomaly benchmark's T = 1,440, B = 256, W = 300 / 96, about 0.011 and
// 0.0032 ms at the H100's 33.5 T float32 adds a second (132 SMs x 128
// lanes x 1,980 MHz: the sums issue each add and product alone), above
// their bytes (the series in and out and the state: 3.3 and 4.6 MB,
// 0.001 ms).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kLaneWindow = 4096;  // "lane" path up to this W (kernels.py
                                   // ANOMALY_LANE_WINDOW)
constexpr int kLaneWarps = 8;      // a lane block's warps on the steps
constexpr int kWideSteps = 8;      // lane path: a warp a step up to this T,
constexpr int kWideWarps = 4;      // as many warps (steps) a block
constexpr int kWarpSteps = 16;     // a warp block's warps (steps a tile)
constexpr int kFillBlocks = 264;   // warp path: blocks to aim for (2 an SM)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSqrt2 = 1.4142135623730951f;  // f32(sqrt 2), as torch's

struct Pair {
  float a, b;
};

__device__ __forceinline__ float add(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ Pair add(Pair x, Pair y) {
  return Pair{__fadd_rn(x.a, y.a), __fadd_rn(x.b, y.b)};
}

// The sum of get(c), ..., get(c + 63) (zeros from get(n) on where kTail)
// as a tree of fours: 16 blocks of 4 terms, 4 groups of 4 blocks, the 4
// groups, each sum taken from zero in turn. A tail's blocks and groups
// past n are zeros, which change no sum: they are skipped.
template <bool kTail, typename V, typename Get>
__device__ __forceinline__ V tree64(const Get& get, int c, int n) {
  V total{};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (kTail && c + 16 * q >= n) break;
    V group{};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k0 = c + 16 * q + 4 * r;
      if (kTail && k0 >= n) break;
      V s{};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s = add(s, !kTail || k0 + j < n ? get(k0 + j) : V{});
      group = add(group, s);
    }
    total = add(total, group);
  }
  return total;
}

// The sum of get(0), ..., get(n - 1) in the stages' order (see above;
// tests/test_torch_encoders.py `tree_sum`): a tree of fours six levels
// deep (4,096 terms), the trees of 4,096 added in turn. V is float, or
// Pair for two sums at once. With kOld, a whole run of 64 terms from
// term `old` on is read by get_old, which gives the same values with no
// branch (the terms from before the launch, in the carried rings).
template <typename V, bool kOld, typename Get, typename GetOld>
__device__ __forceinline__ V tree_sum(const Get& get, int n, int old,
                                      const GetOld& get_old) {
  V total{};
  for (int c6 = 0; c6 < n; c6 += 4096) {
    const int e6 = min(n, c6 + 4096);
    V s6{};
    for (int c5 = c6; c5 < e6; c5 += 1024) {
      const int e5 = min(e6, c5 + 1024);
      V s5{};
      for (int c4 = c5; c4 < e5; c4 += 256) {
        const int e4 = min(e5, c4 + 256);
        V s4{};
        for (int c3 = c4; c3 < e4; c3 += 64) {
          V t;
          if (c3 + 64 > n)
            t = tree64<true, V>(get, c3, n);
          else if (kOld && c3 >= old)
            t = tree64<false, V>(get_old, c3, n);
          else
            t = tree64<false, V>(get, c3, n);
          s4 = add(s4, t);
        }
        s5 = add(s5, s4);
      }
      s6 = add(s6, s5);
    }
    total = add(total, s6);
  }
  return total;
}

template <typename V, typename Get>
__device__ __forceinline__ V tree_sum(const Get& get, int n) {
  return tree_sum<V, false>(get, n, n, get);
}

__device__ __forceinline__ float shfl(float v, int from) {
  return __shfl_sync(kFull, v, from);
}
__device__ __forceinline__ Pair shfl(Pair v, int from) {
  return Pair{__shfl_sync(kFull, v.a, from), __shfl_sync(kFull, v.b, from)};
}

// tree_sum's very sum by the 32 lanes of a warp, for the latency of one
// step: in each round lane l sums the group of 16 terms l (+ 32 a round)
// as tree_sum does, and the warp adds the groups' sums up the same tree
// of fours by shuffles: runs of 64 (4 lanes), 256 (16 lanes), 1,024 (a
// round's two halves and the next round's), 4,096, then in turn. Every
// lane returns it.
template <typename V, typename Get>
__device__ __forceinline__ V tree_sum_warp(const Get& get, int n, int lane) {
  const int rounds = (n + 511) / 512;
  V total{}, s6{}, s5{};
  for (int r = 0; r < rounds; ++r) {
    const int c = 16 * (lane + 32 * r);
    V g{};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      V block{};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c + 4 * q + j;
        block = add(block, k < n ? get(k) : V{});
      }
      g = add(g, block);
    }
    V s3{}, s4{};
#pragma unroll
    for (int i = 0; i < 4; ++i) s3 = add(s3, shfl(g, (lane & ~3) + i));
#pragma unroll
    for (int i = 0; i < 4; ++i) s4 = add(s4, shfl(s3, (lane & ~15) + 4 * i));
    if ((r & 1) == 0) s5 = V{};
    s5 = add(add(s5, shfl(s4, 0)), shfl(s4, 16));
    if ((r & 1) == 1 || r == rounds - 1) {
      if ((r & 7) < 2) s6 = V{};
      s6 = add(s6, s5);
      if ((r & 7) >= 6 || r == rounds - 1) total = add(total, s6);
    }
  }
  return total;
}

// The sum of the warp's 32 partials, equal in every lane: lane i adds the
// partial of lane i ^ d for d = 16, 8, 4, 2, 1 (float addition commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Two such sums at once, their shuffles interleaved.
__device__ __forceinline__ Pair warp_sum2(Pair p) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float oa = __shfl_xor_sync(kFull, p.a, d);
    const float ob = __shfl_xor_sync(kFull, p.b, d);
    p.a = __fadd_rn(p.a, oa);
    p.b = __fadd_rn(p.b, ob);
  }
  return p;
}

// The median of three lags, the middle value (one of them: exact).
__device__ __forceinline__ float median3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// The value of rank (k - 1) / 2 among at(1), ..., at(k): the first whose
// count of smaller values is at most that rank and whose count of values
// not greater is above it (one of the values: exact). Three lags (every
// shipped configuration) take median3.
template <typename At>
__device__ __forceinline__ float median(const At& at, int k) {
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

// x mod n in [0, n) for n >= 1, as torch.remainder gives it.
__device__ __forceinline__ int wrap(int x, int n) {
  const int m = x % n;
  return m < 0 ? m + n : m;
}

// The series x (T, B) of stream b, strides ts and bs in elements, float32
// or float64: step t's value rounded to float32.
template <typename In>
struct Series {
  const In* x;
  long long ts, bs, b;
  __device__ float operator()(int t) const {
    return static_cast<float>(x[(long long)t * ts + b * bs]);
  }
};

// The likelihood's scores by step of this launch: the series' from step
// 0 on, before it (-W <= u < 0) the carried ring's slot (pos0 + u) mod W.
template <typename In>
struct Scores {
  Series<In> series;
  const float* ring;  // stream b's carried ring (null: zeros)
  int W, pos0;
  __device__ float carried(int u) const {
    const int s = pos0 + u;
    return ring ? ring[s < 0 ? s + W : s] : 0.0f;
  }
  __device__ float operator()(int u) const {
    return u >= 0 ? series(u) : carried(u);
  }
};

// The z-score's values and residuals by absolute step s (the step counter
// pos): the series' from tau0 on, before it the carried lag ring's slot s
// mod L; r from v and its k lags from tau0 on, before it the carried
// residual ring's slot s mod W.
template <typename In>
struct Residuals {
  Series<In> series;
  const float* lag;    // stream b's carried lag ring (null: zeros)
  const float* resid;  // its residual ring (null: zeros)
  int L, W, P, k, tau0;
  __device__ float value(int s) const {
    if (s >= tau0) return series(s - tau0);
    return lag ? lag[wrap(s, L)] : 0.0f;
  }
  __device__ float carried(int s) const {
    return resid ? resid[wrap(s, W)] : 0.0f;
  }
  __device__ float fresh(int s) const {  // s >= tau0
    if (s < L) return 0.0f;
    const float med = median([&](int a) { return value(s - a * P); }, k);
    return __fsub_rn(value(s), med);
  }
  __device__ float operator()(int s) const {
    return s < tau0 ? carried(s) : fresh(s);
  }
};

// A step's likelihood from its sums and its short mean.
__device__ __forceinline__ float likelihood(float mean, float var,
                                            float short_mean, int nc,
                                            int R) {
  if (nc < R + 10) return 0.5f;
  const float sd = __fsqrt_rn(var < 1e-8f ? 1e-8f : var);
  const float z = __fdiv_rn(__fsub_rn(short_mean, mean), sd);
  return __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fdiv_rn(z, kSqrt2))));
}

// A step's z from its sums s (over n, the live count clamped to 1), its
// residual r and its step t.
__device__ __forceinline__ float zscore(Pair s, float nf, float r, int t,
                                        int L, int W, float eps) {
  const float mean = __fdiv_rn(s.a, nf);
  const float d = __fsub_rn(__fdiv_rn(s.b, nf), __fmul_rn(mean, mean));
  const float var = d < eps ? eps : d;
  return t >= L + W ? __fdiv_rn(__fsub_rn(r, mean), __fsqrt_rn(var)) : 0.0f;
}

// The EMA of short means over the steps [from, to) by the whole warp,
// each lane holding the same sm: the scores read 32 steps a round, a lane
// a step, then taken in turn by shuffles; short_t goes to out[t - from]
// where out is not null.
template <typename In>
__device__ float ema(float sm, int from, int to, float* out,
                     const Series<In>& series, int count0, float m,
                     float one_minus, int lane) {
  for (int t = from; t < to; t += 32) {
    const float v = t + lane < to ? series(t + lane) : 0.0f;
    const int n = min(32, to - t);
    for (int i = 0; i < n; ++i) {
      const float s = __shfl_sync(kFull, v, i);
      sm = __fmaf_rn(s, one_minus, __fmul_rn(m, count0 > -(t + i) ? sm : s));
      if (out && lane == 0) out[t + i - from] = sm;
    }
  }
  return sm;
}

// count' of step t of a launch from count0.
__device__ __forceinline__ int count_after(int count0, int t, int W) {
  return count0 >= W - t - 1 ? W : count0 + t + 1;
}

// The lane path of the likelihood: a block a stream (grid x), warp 0 the
// producer, the other threads a step each; kWide (a short series): a
// warp a step, each warp running the tile's EMA itself (no producer).
template <typename In, bool kWide>
__global__ void __launch_bounds__(32 * (1 + kLaneWarps))
    likelihood_lane(const float* __restrict__ ring_in,
                    const int* __restrict__ pos_in,
                    const int* __restrict__ count_in,
                    const float* __restrict__ short_in,
                    const In* __restrict__ x, long long ts, long long bs,
                    float* __restrict__ ring_out, int* __restrict__ pos_out,
                    int* __restrict__ count_out,
                    float* __restrict__ short_out, float* __restrict__ lik,
                    int T, int B, int W, int R, float m, float one_minus) {
  extern __shared__ float smem[];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int TT = kWide ? nthreads / 32 : nthreads - 32;  // steps a tile
  const int H = W - 1 + TT;      // the scores a tile holds
  float* shorts = smem;          // the tile's short means
  float* vals = smem + TT;       // the scores of steps first .. first + H - 1
  const int pos0 = wrap(pos_in ? pos_in[b] : 0, W);
  const int count0 = count_in ? count_in[b] : 0;
  const int lo = R > 0 ? R : 0;  // the est ages are [lo, count')
  const Scores<In> score{{x, ts, bs, b}, ring_in ? ring_in + b * W : nullptr,
                         W, pos0};
  float sm = short_in ? short_in[b] : 0.0f;  // the EMA
  const int last = pos0 + T - 1;
  auto step_ema = [&](int t, float s) {
    sm = __fmaf_rn(s, one_minus, __fmul_rn(m, count0 > -t ? sm : s));
  };
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int first = t0 - W + 1;
    const int split = min(H, -first > 0 ? -first : 0);  // carried below
    if (split > 0) {  // the carried ring in slot order (no wait on pos0):
#pragma unroll 8      // slot j holds the score of step j - pos0 (- W)
      for (int j = tid; j < W; j += nthreads) {
        const float v = score.ring ? score.ring[j] : 0.0f;
        const int u = j - pos0 < 0 ? j - pos0 : j - pos0 - W;
        if (u - first >= 0 && u - first < split) vals[u - first] = v;
      }
    }
#pragma unroll 8
    for (int h = split + tid; h < H; h += nthreads)
      vals[h] = first + h < T ? score.series(first + h) : 0.0f;
    __syncthreads();
    const int steps = min(TT, T - t0);
    if (t0 + TT >= T)  // the last tile: slot j's last score, of step T - 1
      for (int j = tid; j < W; j += nthreads)  // - its age
        ring_out[b * W + j] = vals[T - 1 - wrap(last - j, W) - first];
    const float* s_at = vals + (W - 1);  // the tile's scores
    if (!kWide && tid == 0)
      for (int i = 0; i < steps; ++i) {
        step_ema(t0 + i, s_at[i]);
        shorts[i] = sm;
      }
    const int i = kWide ? warp : tid - 32;  // the step in the tile
    const bool mine = (kWide || tid >= 32) && i < steps;
    const int t = t0 + i;
    const int nc = count_after(count0, t, W);
    const int n = nc - lo > 0 ? nc - lo : 0;
    const float nf = (float)(n > 1 ? n : 1);
    float mean = 0.0f, var = 0.0f;
    if (mine) {
      const float* p = vals + (t - first - lo);  // age lo, then older
      auto at = [&](int k) { return p[-k]; };
      auto sq = [&](int k) {
        const float d = __fsub_rn(p[-k], mean);
        return __fmul_rn(d, d);
      };
      if (kWide) {
        mean = __fdiv_rn(tree_sum_warp<float>(at, n, lane), nf);
        var = __fdiv_rn(tree_sum_warp<float>(sq, n, lane), nf);
      } else {
        mean = __fdiv_rn(tree_sum<float>(at, n), nf);
        var = __fdiv_rn(tree_sum<float>(sq, n), nf);
      }
    }
    if (kWide) {  // every warp runs the tile's EMA, keeping its own step's
      float own = 0.0f;
      for (int k = 0; k < steps; ++k) {
        step_ema(t0 + k, s_at[k]);
        own = k == i ? sm : own;
      }
      if (mine && lane == 0)
        lik[(long long)t * B + b] = likelihood(mean, var, own, nc, R);
      __syncthreads();  // the tile is read before the next one's
    } else {
      __syncthreads();  // the tile's short means are written
      if (mine) lik[(long long)t * B + b] = likelihood(mean, var, shorts[i],
                                                       nc, R);
    }
  }
  if (T == 0)
    for (int j = tid; j < W; j += nthreads)
      ring_out[b * W + j] = score(T - 1 - wrap(last - j, W));
  if (tid == 0) {
    pos_out[b] = T > 0 ? wrap(pos0 + T, W) : (pos_in ? pos_in[b] : 0);
    count_out[b] = T == 0 ? count0 : count_after(count0, T - 1, W);
    short_out[b] = sm;
  }
}

// The warp path of the likelihood: a stream's steps in tiles over
// gridDim.y blocks (block y takes the tiles y, y + gridDim.y, ...), warp
// 0 the producer (which runs the EMA from step 0 through its block's
// tiles), the other warps a step each, reading each window from the
// series and the carried ring.
template <typename In>
__global__ void __launch_bounds__(32 * (1 + kWarpSteps))
    likelihood_warp(const float* __restrict__ ring_in,
                    const int* __restrict__ pos_in,
                    const int* __restrict__ count_in,
                    const float* __restrict__ short_in,
                    const In* __restrict__ x, long long ts, long long bs,
                    float* __restrict__ ring_out, int* __restrict__ pos_out,
                    int* __restrict__ count_out,
                    float* __restrict__ short_out, float* __restrict__ lik,
                    int T, int B, int W, int R, float m, float one_minus) {
  extern __shared__ float smem[];  // the tile's short means
  const long long b = blockIdx.x;
  const int g = blockIdx.y, G = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int TS = nthreads / 32 - 1;  // steps a tile
  const int pos0 = wrap(pos_in ? pos_in[b] : 0, W);
  const int count0 = count_in ? count_in[b] : 0;
  const int lo = R > 0 ? R : 0;
  const Scores<In> score{{x, ts, bs, b}, ring_in ? ring_in + b * W : nullptr,
                         W, pos0};
  const int last = pos0 + T - 1;  // the new ring, shared by the blocks
  for (int j = g * nthreads + tid; j < W; j += G * nthreads)
    ring_out[b * W + j] = score(T - 1 - wrap(last - j, W));
  float sm = short_in ? short_in[b] : 0.0f;
  if (g == 0 && tid == 0) {
    pos_out[b] = T > 0 ? wrap(pos0 + T, W) : (pos_in ? pos_in[b] : 0);
    count_out[b] = T == 0 ? count0 : count_after(count0, T - 1, W);
    if (T == 0) short_out[b] = sm;
  }
  int at = 0;  // the producer's next step
  for (int t0 = g * TS; t0 < T; t0 += G * TS) {
    const int steps = min(TS, T - t0);
    if (warp == 0) {
      sm = ema(sm, at, t0, nullptr, score.series, count0, m, one_minus, lane);
      sm = ema(sm, t0, t0 + steps, smem, score.series, count0, m, one_minus,
               lane);
      at = t0 + steps;
    }
    const int t = t0 + warp - 1;
    const int nc = count_after(count0, t, W);
    const int n = nc - lo > 0 ? nc - lo : 0;
    const float nf = (float)(n > 1 ? n : 1);
    float mean = 0.0f, var = 0.0f;
    if (warp > 0 && warp <= steps) {
      // lane l's ages lo + l + 32 q: the score of step ul - 32 q, from
      // q_old on from before the launch (the carried ring's slot sb - 32 q)
      const int ul = t - lo - lane;
      const int q_n = n > lane ? (n - lane + 31) >> 5 : 0;
      const int q_old = ul >= 0 ? ul / 32 + 1 : 0;
      const int sb = wrap(pos0 + ul, W);
      auto old_q = [&](int q) {
        const int j = sb - 32 * q;
        return score.ring ? score.ring[j < 0 ? j + W : j] : 0.0f;
      };
      auto at_q = [&](int q) {  // both read: no branch
        const int u = ul - 32 * q;
        const float v = score.series(u > 0 ? u : 0);
        const float c = old_q(q);
        return u >= 0 ? v : c;
      };
      auto sq = [&](float v) {
        const float d = __fsub_rn(v, mean);
        return __fmul_rn(d, d);
      };
      mean = __fdiv_rn(
          warp_sum(tree_sum<float, true>(at_q, q_n, q_old, old_q)), nf);
      var = __fdiv_rn(warp_sum(tree_sum<float, true>(
                          [&](int q) { return sq(at_q(q)); }, q_n, q_old,
                          [&](int q) { return sq(old_q(q)); })),
                      nf);
    }
    __syncthreads();  // the tile's short means are written
    if (warp > 0 && warp <= steps && lane == 0)
      lik[(long long)t * B + b] = likelihood(mean, var, smem[warp - 1], nc,
                                             R);
    __syncthreads();  // read before the next tile's
  }
  if (warp == 0 && lane == 0 && T > 0 && at == T) short_out[b] = sm;
}

// The lane path of the z-score: a block a stream, a thread a step (kWide:
// a warp a step, for a short series).
template <typename In, bool kWide>
__global__ void __launch_bounds__(32 * kLaneWarps)
    zscore_lane(const float* __restrict__ lag_in,
                const float* __restrict__ resid_in,
                const int* __restrict__ pos_in, const In* __restrict__ x,
                long long ts, long long bs, float* __restrict__ lag_out,
                float* __restrict__ resid_out, int* __restrict__ pos_out,
                float* __restrict__ zout, int T, int B, int L, int W, int P,
                float eps) {
  extern __shared__ float smem[];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int TT = kWide ? nthreads / 32 : nthreads;  // steps a tile
  const int H = W + TT;     // the residuals a tile holds
  float* vals = smem;       // the residuals of steps first .. first + H - 1
  const int tau0 = pos_in ? pos_in[b] : 0;  // the step counter at launch
  const int end = tau0 + T;
  const Residuals<In> res{{x, ts, bs, b},
                          lag_in ? lag_in + b * L : nullptr,
                          resid_in ? resid_in + b * W : nullptr,
                          L, W, P, L / P, tau0};
#pragma unroll 4
  for (int j = tid; j < L; j += nthreads)  // slot j's last value
    lag_out[b * L + j] = res.value(end - 1 - wrap(end - 1 - j, L));
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int start = tau0 + t0;  // the tile's first step
    const int first = start - W;
#pragma unroll 8
    for (int h = tid; h < W; h += nthreads)  // before the tile: W steps
      vals[h] = first + h < tau0 ? res.carried(first + h) : 0.0f;
    for (int h = tid; h < H; h += nthreads) {
      const int s = first + h;
      if (s >= tau0 && s < end) vals[h] = res.fresh(s);
      else if (h >= W) vals[h] = 0.0f;
    }
    __syncthreads();
    if (t0 + TT >= T)  // the last tile: slot j's last residual
      for (int j = tid; j < W; j += nthreads)
        resid_out[b * W + j] = vals[end - 1 - wrap(end - 1 - j, W) - first];
    const int i = kWide ? tid >> 5 : tid;  // the step in the tile
    const int t = start + i;
    if (i < T - t0) {
      const int live = t < W ? (t > 0 ? t : 0) : W;  // ages 1 .. live
      const float* p = vals + (t - 1 - first);      // age 1, then older
      auto at = [&](int q) {
        const float e = p[-q];
        return Pair{e, __fmul_rn(e, e)};
      };
      const Pair s = kWide ? tree_sum_warp<Pair>(at, live, tid & 31)
                           : tree_sum<Pair>(at, live);
      if (!kWide || (tid & 31) == 0)
        zout[(long long)(t0 + i) * B + b] = zscore(
            s, (float)(t < 1 ? 1 : live), vals[t - first], t, L, W, eps);
    }
    __syncthreads();  // every window of the tile is read
  }
  if (T == 0)
    for (int j = tid; j < W; j += nthreads)
      resid_out[b * W + j] = res(end - 1 - wrap(end - 1 - j, W));
  if (tid == 0) pos_out[b] = end;
}

// The warp path of the z-score: a stream's steps in tiles over gridDim.y
// blocks, a warp a step, each window's residuals from the inputs.
template <typename In>
__global__ void __launch_bounds__(32 * kWarpSteps)
    zscore_warp(const float* __restrict__ lag_in,
                const float* __restrict__ resid_in,
                const int* __restrict__ pos_in, const In* __restrict__ x,
                long long ts, long long bs, float* __restrict__ lag_out,
                float* __restrict__ resid_out, int* __restrict__ pos_out,
                float* __restrict__ zout, int T, int B, int L, int W, int P,
                float eps) {
  const long long b = blockIdx.x;
  const int g = blockIdx.y, G = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int TS = nthreads / 32;  // steps a tile
  const int tau0 = pos_in ? pos_in[b] : 0;
  const int end = tau0 + T;
  const Residuals<In> res{{x, ts, bs, b},
                          lag_in ? lag_in + b * L : nullptr,
                          resid_in ? resid_in + b * W : nullptr,
                          L, W, P, L / P, tau0};
  for (int j = g * nthreads + tid; j < L; j += G * nthreads)
    lag_out[b * L + j] = res.value(end - 1 - wrap(end - 1 - j, L));
  for (int j = g * nthreads + tid; j < W; j += G * nthreads)
    resid_out[b * W + j] = res(end - 1 - wrap(end - 1 - j, W));
  if (g == 0 && tid == 0) pos_out[b] = end;
  for (int t0 = g * TS + warp; t0 < T; t0 += G * TS) {
    const int t = tau0 + t0;
    const int live = t < W ? (t > 0 ? t : 0) : W;
    // lane l's ages 1 + l + 32 q: the residual of step ul - 32 q, from
    // q_old on from before the launch (the carried ring's slot sb - 32 q)
    const int ul = t - 1 - lane;
    const int q_n = live > lane ? (live - lane + 31) >> 5 : 0;
    const int q_old = ul >= tau0 ? (ul - tau0) / 32 + 1 : 0;
    const int sb = wrap(ul, W);
    const Pair s = warp_sum2(tree_sum<Pair, true>(
        [&](int q) {
          const float e = res(ul - 32 * q);
          return Pair{e, __fmul_rn(e, e)};
        },
        q_n, q_old,
        [&](int q) {
          const int j = sb - 32 * q;
          const float e = res.resid ? res.resid[j < 0 ? j + W : j] : 0.0f;
          return Pair{e, __fmul_rn(e, e)};
        }));
    if (lane == 0)
      zout[(long long)t0 * B + b] =
          zscore(s, (float)(t < 1 ? 1 : live), res(t), t, L, W, eps);
  }
}

// The block's threads: the likelihood's producer warp (`producer`) and
// the warps on the steps, a thread a step on the lane path (at most
// kLaneWarps warps, no more than T needs; kWideWarps, a warp a step,
// where T is at most kWideSteps) or a warp a step on the warp path (at
// most kWarpSteps, no more than fill kFillBlocks blocks with the tiles).
int block_threads(bool lane, bool producer, int T, int B) {
  const int steps = T > 1 ? T : 1;
  int warps;
  if (lane && T <= kWideSteps) {
    return 32 * kWideWarps;  // every warp its own EMA: no producer
  } else if (lane) {
    warps = (steps + 31) / 32;
    warps = warps < kLaneWarps ? warps : kLaneWarps;
  } else {
    const long long per = ((long long)steps * B + kFillBlocks - 1) /
                          kFillBlocks;  // steps a block to fill the card
    warps = per < kWarpSteps ? (int)per : kWarpSteps;
  }
  return 32 * (warps + (producer ? 1 : 0));
}

// The warp path's blocks a stream: the tiles of TS steps, at most as many
// as fill kFillBlocks blocks (and grid y's 65,535).
unsigned stream_blocks(int T, int TS, int B) {
  const long long tiles = ((long long)(T > 1 ? T : 1) + TS - 1) / TS;
  long long fill = ((long long)kFillBlocks + B - 1) / B;
  fill = fill < 1 ? 1 : fill;
  const long long g = tiles < fill ? tiles : fill;
  return (unsigned)(g < 65535 ? g : 65535);
}

// Launches kernel over B streams (grid x) and `per` blocks a stream (grid
// y), a block of `threads` with `floats` floats of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, long long floats, int B, unsigned per,
           cudaStream_t stream, Args... args) {
  const size_t smem = (size_t)floats * sizeof(float);
  if (smem > bithtm::kMaxShared) return (int)cudaErrorInvalidValue;
  if (int err = bithtm::allow_shared(kernel, smem)) return err;
  kernel<<<dim3((unsigned)B, per), threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
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
  const bool lane = W <= kLaneWindow;
  const bool wide = lane && T <= kWideSteps;
  const int threads = block_threads(lane, true, T, B);
  const int tile = wide ? threads / 32 : lane ? threads - 32 : threads / 32 - 1;
  const long long floats = lane ? (long long)W - 1 + 2 * tile : tile;
  const unsigned per = lane ? 1 : stream_blocks(T, tile, B);
  auto run = [&](auto k, auto in) {
    return launch(k, threads, floats, B, per, s, scores_in, pos_in,
                  count_in, short_in, in, x_ts, x_bs, scores_out, pos_out,
                  count_out, short_out, lik, T, B, W, R, m, one_minus);
  };
  const float* xf = static_cast<const float*>(x);
  const double* xd = static_cast<const double*>(x);
  if (wide)
    return x_f64 ? run(likelihood_lane<double, true>, xd)
                 : run(likelihood_lane<float, true>, xf);
  if (lane)
    return x_f64 ? run(likelihood_lane<double, false>, xd)
                 : run(likelihood_lane<float, false>, xf);
  return x_f64 ? run(likelihood_warp<double>, xd)
               : run(likelihood_warp<float>, xf);
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
  const bool lane = W <= kLaneWindow;
  const bool wide = lane && T <= kWideSteps;
  const int threads = block_threads(lane, false, T, B);
  const long long floats =
      lane ? (long long)W + (wide ? threads / 32 : threads) : 0;
  const unsigned per = lane ? 1 : stream_blocks(T, threads / 32, B);
  auto run = [&](auto k, auto in) {
    return launch(k, threads, floats, B, per, s, lag_in, resid_in, pos_in,
                  in, x_ts, x_bs, lag_out, resid_out, pos_out, z, T, B, L, W,
                  P, eps);
  };
  const float* xf = static_cast<const float*>(x);
  const double* xd = static_cast<const double*>(x);
  if (wide)
    return x_f64 ? run(zscore_lane<double, true>, xd)
                 : run(zscore_lane<float, true>, xf);
  if (lane)
    return x_f64 ? run(zscore_lane<double, false>, xd)
                 : run(zscore_lane<float, false>, xf);
  return x_f64 ? run(zscore_warp<double>, xd) : run(zscore_warp<float>, xf);
}
