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
// of noise per column (9 B at M = 5) for ~15 float operations, far below the
// card's ~20 float operations per byte of HBM bandwidth.  Design:
//   * one thread per column loops over all S samples inside the block; the
//     Pallas kernel's sequential sample-grid axis has no GPU counterpart, and
//     a column's bias never leaves the thread's registers;
//   * neighbouring threads own neighbouring columns, so every operand-bit and
//     noise load of a warp is one contiguous segment;
//   * operand bits are uint8 (4x fewer bytes than the reference's float32);
//   * bias is counted as an int32 and divided by S once, so it equals the
//     plain version's float sum / S exactly (a sum of {-1, 0, 1} in float32
//     is exact below 2^24);
//   * every float operation is an explicit round-to-nearest intrinsic in the
//     plain version's order (no fused multiply-add, IEEE division and sqrt):
//     one ulp flips a threshold test.  Operand swing is sample-invariant for
//     {0, 1} bits (each term is exactly 1), so sigma is computed once per
//     column from the same float32 values the plain version sums.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;

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

__global__ void __launch_bounds__(256)
calib_iter_kernel(const uint8_t* __restrict__ inputs,  // [G, S, M, C]
                  const float* __restrict__ noise,     // [G, S, C]
                  const int32_t* __restrict__ levels,  // [G, C]
                  const float* __restrict__ offset,    // [G, C]
                  int32_t* __restrict__ levels_out,    // [G, C]
                  float* __restrict__ bias_out,        // [G, C]
                  int G, int S, int M, int C, Ladder ladder, Consts k) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= (int64_t)G * C) return;
  const int64_t g = col / C;
  const int64_t c = col - g * C;

  const int lvl = levels[col];
  float qsum = 0.f, swing = 0.f;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l == lvl) {
      qsum = ladder.qsum[l];
      swing = ladder.swing[l];
    }
  }
  // swing_sq = (sum over M operands of 1.0) + swing + const_swing
  const float swing_sq = __fadd_rn(__fadd_rn((float)M, swing), k.const_swing);
  const float sigma =
      __fsqrt_rn(__fadd_rn(k.var_const, __fmul_rn(k.sigma_t2, swing_sq)));
  const float thr = __fadd_rn(k.neutral, offset[col]);

  const uint8_t* in = inputs + g * (int64_t)S * M * C + c;
  const float* nz = noise + g * (int64_t)S * C + c;
  int count = 0;
  for (int s = 0; s < S; ++s) {
    int ones = 0;
    for (int m = 0; m < M; ++m) ones += in[((int64_t)s * M + m) * C];
    const float cs =
        __fadd_rn(__fadd_rn((float)ones, qsum), k.const_charge);
    const float v = __fdiv_rn(__fadd_rn(__fmul_rn(cs, k.c_cell), k.neutral_bl),
                              k.c_total);
    const float sensed_v = __fadd_rn(v, __fmul_rn(sigma, nz[(int64_t)s * C]));
    const int sensed = sensed_v > thr ? 1 : 0;
    const int truth = ones > k.maj_half ? 1 : 0;
    count += sensed - truth;
  }
  const float bias = __fdiv_rn((float)count, (float)S);
  int step = 0;
  if (bias > k.threshold) step -= 1;
  if (bias < k.neg_threshold) step += 1;
  int nl = lvl + step;
  nl = nl < 0 ? 0 : (nl > ladder.n_levels - 1 ? ladder.n_levels - 1 : nl);
  levels_out[col] = nl;
  bias_out[col] = bias;
}

}  // namespace

extern "C" int calib_iter_launch(
    const void* inputs, const void* noise, const void* levels,
    const void* offset, void* levels_out, void* bias_out,
    int G, int S, int M, int C,
    const float* qsum, const float* swing, int n_levels,
    float c_cell, float neutral_bl, float c_total, float neutral,
    float var_const, float sigma_t2, float const_charge, float const_swing,
    float threshold, float neg_threshold, int maj_half, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Ladder ladder{};
  for (int l = 0; l < n_levels; ++l) {
    ladder.qsum[l] = qsum[l];
    ladder.swing[l] = swing[l];
  }
  ladder.n_levels = n_levels;
  Consts k{c_cell, neutral_bl, c_total, neutral, var_const, sigma_t2,
           const_charge, const_swing, threshold, neg_threshold, maj_half};
  const int64_t total = (int64_t)G * C;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  calib_iter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)inputs, (const float*)noise, (const int32_t*)levels,
      (const float*)offset, (int32_t*)levels_out, (float*)bias_out,
      G, S, M, C, ladder, k);
  return (int)cudaGetLastError();
}
