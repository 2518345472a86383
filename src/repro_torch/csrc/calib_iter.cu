// One Algorithm-1 calibration iteration per DRAM column, for Hopper (sm_90a).
//
// Replaces: repro/kernels/majx.py `calib_iter_fused` (Pallas body
// `_calib_iter_kernel`, majx.py:80; pallas_call at majx.py:157).
//
// Per column (g, c) of a [G, C] subarray grid, over S random samples of M
// operand bits: look up the column's ladder level's calibration-row charge
// sum and swing^2 sum (<= 8 levels, passed by value in the kernel arguments),
// compute the charge-sharing bitline voltage and sensing sigma, sense
// `v + sigma * noise > 0.5 + offset`, count (sensed - MAJ truth), and step
// the level +-1 past the threshold, clipped to the ladder.
//
// Bound on the H100: bytes.  Each sample reads M operand bytes and one float
// of noise per column (9 B at M = 5) and nothing else; at the main path's
// [16, 256, 5, 65,536] that is 2.4 GB, 0.73 ms at 3.35 TB/s, which the
// kernel reaches at 90%.  What stands in the way is instruction work per
// byte: an IEEE division per sample, and one-byte loads of which a warp's
// instruction fetches 32 bytes.  Design:
//   * the voltage hoisted out of the sample loop.  v depends only on the
//     number of ones among the M operands and on the column's level, so
//     each thread computes the M + 1 voltages of each of its columns once,
//     with the plain version's rounded operations in its order, into a
//     table in shared memory ([M + 1][4 columns][threads], so a warp's
//     lookups fall in 32 distinct banks whatever counts its lanes hold).  A
//     sample then costs a lookup, one multiply, one add and two compares;
//     the result is the plain version's by construction;
//   * four adjacent columns per thread.  On the vector path (C and the base
//     pointers aligned, as on the main path) an operand row of four columns
//     is one 32-bit load and the M rows add up as words: each byte holds a
//     count of at most M <= 255, so nothing carries into the next column.
//     Noise, levels and offsets move as 16-byte float4 / int4.  A warp's
//     operand load is one 128-byte line, its noise load four;
//   * bytes in flight: four blocks of 256 share an SM (the launch bounds
//     hold a thread to 64 registers), so each SM has 1,024 threads x 36 B
//     = 36 KB of loads in flight per sample, above the ~20 KB that the
//     card's memory rate needs, and the main path's 1,024 blocks run in
//     two full waves; so unrolling the sample loop adds nothing (measured,
//     PERF.md §6);
//   * M is a template parameter (an instance for 5, one that takes M at
//     run time), so the main path's operand loads unroll;
//   * ragged shapes run in the same kernel: where C or a pointer is not
//     aligned (C = 77 or 1,001), a thread reads its up to four columns byte
//     by byte, packs them into the same word and masks the columns past C;
//   * bias is counted as an int32 and divided by S once, so it equals the
//     plain version's float sum / S exactly (a sum of {-1, 0, 1} in float32
//     is exact below 2^24);
//   * every float operation is an explicit round-to-nearest intrinsic in the
//     plain version's order (built with -fmad=false; IEEE division and
//     sqrt): one ulp flips a threshold test.  Operand swing is
//     sample-invariant for {0, 1} bits (each term is exactly 1), so sigma is
//     computed once per column from the same float32 values the plain
//     version sums.
// The plan (vector path or not, threads, shared bytes, blocks) is made on
// the host (kernels/calib_iter.py `plan_launch`); the launch checks it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kCols = 4;       // adjacent columns per thread
constexpr int kMaxThreads = 256;
constexpr int kMaxM = 255;     // a byte holds each column's count of ones

struct Ladder {
  float qsum[kMaxLevels];   // per-level calibration-row charge sum
  float swing[kMaxLevels];  // per-level calibration-row swing^2 sum
  int n_levels;
};

struct Consts {
  float c_cell;        // f32(c_cell_ff)
  float neutral_bl;    // f32(NEUTRAL * c_bitline_ff)
  float c_total;       // f32(c_total_ff(n_simra_rows))
  float neutral;       // f32(NEUTRAL)
  float var_const;     // f32(f32(sd^2) + f32(sf^2) * f32(n_fracs))
  float sigma_t2;      // f32(st^2)
  float const_charge;  // f32(const_charge_sum)
  float const_swing;   // f32(const_swing_sq)
  float threshold;     // f32(threshold)
  float neg_threshold; // f32(-threshold)
  int maj_half;        // maj_inputs // 2
};

// The host's plan, field order as kernels/calib_iter.py `Plan.FIELDS`.
struct Plan {
  int vec, threads, smem_bytes, blocks;
};

// Bitline voltage of a SiMRA with `ones` operand ones on a level whose
// calibration rows hold `qsum`: the plain version's operations in order.
__device__ __forceinline__ float voltage(int ones, float qsum,
                                         const Consts& k) {
  const float cs = __fadd_rn(__fadd_rn((float)ones, qsum), k.const_charge);
  return __fdiv_rn(__fadd_rn(__fmul_rn(cs, k.c_cell), k.neutral_bl),
                   k.c_total);
}

// Counts of ones of the thread's four columns in one sample, one per byte.
// `p` points at operand row 0 of the sample at the thread's first column.
template <int kM, bool kVec>
__device__ __forceinline__ uint32_t load_ones(const uint8_t* __restrict__ p,
                                              int M, int C, int ncol) {
  uint32_t w = 0;
  if (kVec) {
    if (kM > 0) {
      uint32_t a[kM > 0 ? kM : 1];
#pragma unroll
      for (int m = 0; m < kM; ++m)
        a[m] = __ldg(
            reinterpret_cast<const unsigned int*>(p + (int64_t)m * C));
#pragma unroll
      for (int m = 0; m < kM; ++m) w += a[m];
    } else {
      for (int m = 0; m < M; ++m)
        w += __ldg(
            reinterpret_cast<const unsigned int*>(p + (int64_t)m * C));
    }
  } else {
    const int mm = kM > 0 ? kM : M;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (j < ncol) {
        uint32_t ones = 0;
        for (int m = 0; m < mm; ++m) ones += __ldg(p + (int64_t)m * C + j);
        w |= ones << (8 * j);
      }
    }
  }
  return w;
}

template <bool kVec>
__device__ __forceinline__ float4 load_noise(const float* __restrict__ p,
                                             int ncol) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ncol > 0) n.x = __ldg(p);
  if (ncol > 1) n.y = __ldg(p + 1);
  if (ncol > 2) n.z = __ldg(p + 2);
  if (ncol > 3) n.w = __ldg(p + 3);
  return n;
}

// One sample of the thread's four columns: look the voltage up, sense,
// count sensed - truth.  `tab` is the thread's column-0, count-0 entry;
// entry (o, j) sits at (o * kCols + j) * threads.
__device__ __forceinline__ void sense_sample(uint32_t w, float4 n4,
                                             const float* tab, int threads,
                                             int M, int maj_half,
                                             const float (&sigma)[kCols],
                                             const float (&thr)[kCols],
                                             int (&cnt)[kCols]) {
  const float nz[kCols] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int o = min((int)((w >> (8 * j)) & 0xffu), M);
    const float v = tab[(o * kCols + j) * threads];
    const float sv = __fadd_rn(v, __fmul_rn(sigma[j], nz[j]));
    cnt[j] += (sv > thr[j] ? 1 : 0) - (o > maj_half ? 1 : 0);
  }
}

template <int kM, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 4)
calib_iter_kernel(const uint8_t* __restrict__ inputs,  // [G, S, M, C]
                  const float* __restrict__ noise,     // [G, S, C]
                  const int32_t* __restrict__ levels,  // [G, C]
                  const float* __restrict__ offset,    // [G, C]
                  int32_t* __restrict__ levels_out,    // [G, C]
                  float* __restrict__ bias_out,        // [G, C]
                  int G, int S, int M_rt, int C, Ladder ladder, Consts k) {
  extern __shared__ float table[];   // [M + 1][kCols][threads]
  const int M = kM > 0 ? kM : M_rt;
  const int threads = blockDim.x;
  const int ngrp = (C + kCols - 1) / kCols;
  const int64_t item = (int64_t)blockIdx.x * threads + threadIdx.x;
  if (item >= (int64_t)G * ngrp) return;
  const int64_t g = item / ngrp;
  const int c0 = (int)(item - g * ngrp) * kCols;
  const int ncol = kVec ? kCols : min(kCols, C - c0);
  const int64_t col = g * C + c0;

  int lvl[kCols];
  float off[kCols];
  if (kVec) {
    const int4 l4 = __ldg(reinterpret_cast<const int4*>(levels + col));
    const float4 o4 = __ldg(reinterpret_cast<const float4*>(offset + col));
    lvl[0] = l4.x; lvl[1] = l4.y; lvl[2] = l4.z; lvl[3] = l4.w;
    off[0] = o4.x; off[1] = o4.y; off[2] = o4.z; off[3] = o4.w;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      lvl[j] = j < ncol ? __ldg(levels + col + j) : 0;
      off[j] = j < ncol ? __ldg(offset + col + j) : 0.f;
    }
  }

  float* tab = table + threadIdx.x;
  float sigma[kCols], thr[kCols];
  int cnt[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    float qsum = 0.f, swing = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l == lvl[j]) {
        qsum = ladder.qsum[l];
        swing = ladder.swing[l];
      }
    }
    // swing_sq = (sum over M operands of 1.0) + swing + const_swing
    const float swing_sq =
        __fadd_rn(__fadd_rn((float)M, swing), k.const_swing);
    sigma[j] =
        __fsqrt_rn(__fadd_rn(k.var_const, __fmul_rn(k.sigma_t2, swing_sq)));
    thr[j] = __fadd_rn(k.neutral, off[j]);
    cnt[j] = 0;
    for (int o = 0; o <= M; ++o)
      tab[(o * kCols + j) * threads] = voltage(o, qsum, k);
  }

  const uint8_t* in = inputs + g * (int64_t)S * M * C + c0;
  const float* nz = noise + g * (int64_t)S * C + c0;
  const int64_t in_step = (int64_t)M * C;
  for (int s = 0; s < S; ++s)
    sense_sample(load_ones<kM, kVec>(in + s * in_step, M, C, ncol),
                 load_noise<kVec>(nz + (int64_t)s * C, ncol), tab, threads,
                 M, k.maj_half, sigma, thr, cnt);

  int nl[kCols];
  float bias[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    bias[j] = __fdiv_rn((float)cnt[j], (float)S);
    int step = 0;
    if (bias[j] > k.threshold) step -= 1;
    if (bias[j] < k.neg_threshold) step += 1;
    const int v = lvl[j] + step;
    nl[j] = v < 0 ? 0 : (v > ladder.n_levels - 1 ? ladder.n_levels - 1 : v);
  }
  if (kVec) {
    *reinterpret_cast<int4*>(levels_out + col) =
        make_int4(nl[0], nl[1], nl[2], nl[3]);
    *reinterpret_cast<float4*>(bias_out + col) =
        make_float4(bias[0], bias[1], bias[2], bias[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (j < ncol) {
        levels_out[col + j] = nl[j];
        bias_out[col + j] = bias[j];
      }
    }
  }
}

template <int kM, bool kVec>
int launch(const Plan& p, cudaStream_t stream, const void* inputs,
           const void* noise, const void* levels, const void* offset,
           void* levels_out, void* bias_out, int G, int S, int M, int C,
           const Ladder& ladder, const Consts& k) {
  auto kernel = calib_iter_kernel<kM, kVec>;
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<p.blocks, p.threads, p.smem_bytes, stream>>>(
      (const uint8_t*)inputs, (const float*)noise, (const int32_t*)levels,
      (const float*)offset, (int32_t*)levels_out, (float*)bias_out, G, S, M,
      C, ladder, k);
  return (int)cudaGetLastError();
}

// The plan must cover the grid with its thread count, hold the table, and
// take the vector path only where C and every pointer are aligned.
bool plan_ok(const Plan& p, int G, int M, int C, const void* const* ptrs) {
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32)
    return false;
  if (p.smem_bytes != (M + 1) * kCols * p.threads * 4) return false;
  const int64_t items = (int64_t)G * ((C + kCols - 1) / kCols);
  if ((int64_t)p.blocks * p.threads < items ||
      (int64_t)(p.blocks - 1) * p.threads >= items)
    return false;
  if (p.vec) {
    if (C % kCols) return false;
    if ((uintptr_t)ptrs[0] % 4) return false;   // operand words
    for (int i = 1; i < 6; ++i)
      if ((uintptr_t)ptrs[i] % 16) return false;
  }
  return true;
}

}  // namespace

extern "C" int calib_iter_launch(
    const void* inputs, const void* noise, const void* levels,
    const void* offset, void* levels_out, void* bias_out,
    int G, int S, int M, int C,
    const float* qsum, const float* swing, int n_levels,
    float c_cell, float neutral_bl, float c_total, float neutral,
    float var_const, float sigma_t2, float const_charge, float const_swing,
    float threshold, float neg_threshold, int maj_half, const int* plan,
    int plan_len, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (G < 1 || S < 1 || C < 1 || M < 1 || M > kMaxM)
    return (int)cudaErrorInvalidValue;
  if (plan_len != 4) return (int)cudaErrorInvalidValue;
  const Plan p{plan[0], plan[1], plan[2], plan[3]};
  const void* ptrs[6] = {inputs, noise, levels, offset, levels_out, bias_out};
  if (!plan_ok(p, G, M, C, ptrs)) return (int)cudaErrorInvalidValue;
  Ladder ladder{};
  for (int l = 0; l < n_levels; ++l) {
    ladder.qsum[l] = qsum[l];
    ladder.swing[l] = swing[l];
  }
  ladder.n_levels = n_levels;
  const Consts k{c_cell, neutral_bl, c_total, neutral, var_const, sigma_t2,
                 const_charge, const_swing, threshold, neg_threshold,
                 maj_half};
  const cudaStream_t st = (cudaStream_t)stream;
  if (M == 5)
    return p.vec ? launch<5, true>(p, st, inputs, noise, levels, offset,
                                   levels_out, bias_out, G, S, M, C, ladder, k)
                 : launch<5, false>(p, st, inputs, noise, levels, offset,
                                    levels_out, bias_out, G, S, M, C, ladder,
                                    k);
  return p.vec ? launch<0, true>(p, st, inputs, noise, levels, offset,
                                 levels_out, bias_out, G, S, M, C, ladder, k)
               : launch<0, false>(p, st, inputs, noise, levels, offset,
                                  levels_out, bias_out, G, S, M, C, ladder, k);
}
