// Column-parallel SiMRA sensing of T events over C columns, for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/majx.py `majx_sense` (pallas_call at majx.py:197,
// body `_majx_kernel` at majx.py:33).  The same function as one SiMRA of the
// command-level simulator (pud/device.py `simra`), batched over events with
// the noise passed in.
//
// For charge [T, R, C] f32, sense_offset [C] f32 and noise [T, C] f32:
//   v     = (sum_r q * c_cell + 0.5 * c_bitline) / (R * c_cell + c_bitline)
//   swing = sum_r (2 (q - 0.5))^2
//   sigma = sqrt((sd^2 + sf^2 * n_fracs) + st^2 * swing)
//   out   = (v + sigma * noise) > 0.5 + offset      (1.0f or 0.0f)
//
// Bound on the H100: bytes.  Each charge is read once and used for a handful
// of float operations, far below the card's operations-per-byte balance:
// (T R C + 2 T C + C) * 4 bytes at 3.35 TB/s.  Design:
//   * one thread per (event, column); consecutive threads take consecutive
//     columns, so every row's loads and the output store coalesce into
//     128-byte lines; a thread loops over its R rows;
//   * blockIdx.y walks the events (grid-stride past 65,535), blockIdx.x the
//     columns; the ragged column edge is masked, so any T and C launch (the
//     TPU kernel's T % 8 and C % 1024 block contract is a TPU tiling rule
//     and is not carried over);
//   * float rules of the calibration kernel: built with -fmad=false, every
//     product and sum rounds on its own, division and sqrt are the
//     round-to-nearest intrinsics, the rows sum in row order, and every
//     constant arrives as the float32 the plain version uses.  One ulp flips
//     a threshold compare, so the result equals the plain version bit for
//     bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sense_kernel(const float* __restrict__ charge,
             const float* __restrict__ offset,
             const float* __restrict__ noise, float* __restrict__ out, int T,
             int R, int C, float c_cell, float c_bl_half, float c_total,
             float half, float two, float var_const, float st2) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float thr = __fadd_rn(half, __ldg(offset + c));
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const float* q = charge + (int64_t)t * R * C + c;
    float qsum = __ldg(q);
    float d = __fmul_rn(two, __fsub_rn(qsum, half));
    float swing = __fmul_rn(d, d);
    for (int r = 1; r < R; ++r) {
      const float qr = __ldg(q + (int64_t)r * C);
      qsum = __fadd_rn(qsum, qr);
      d = __fmul_rn(two, __fsub_rn(qr, half));
      swing = __fadd_rn(swing, __fmul_rn(d, d));
    }
    const float v = __fdiv_rn(__fadd_rn(__fmul_rn(qsum, c_cell), c_bl_half),
                              c_total);
    const float sigma =
        __fsqrt_rn(__fadd_rn(var_const, __fmul_rn(st2, swing)));
    const int64_t i = (int64_t)t * C + c;
    const float lhs = __fadd_rn(v, __fmul_rn(sigma, __ldg(noise + i)));
    out[i] = lhs > thr ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int simra_sense_launch(const void* charge, const void* offset,
                                  const void* noise, void* out, int T, int R,
                                  int C, float c_cell, float c_bl_half,
                                  float c_total, float half, float two,
                                  float var_const, float st2, void* stream) {
  if (T < 1 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((C + kThreads - 1) / kThreads, T < 65535 ? T : 65535);
  sense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)charge, (const float*)offset, (const float*)noise,
      (float*)out, T, R, C, c_cell, c_bl_half, c_total, half, two, var_const,
      st2);
  return (int)cudaGetLastError();
}
