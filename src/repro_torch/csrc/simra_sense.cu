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
// Bound on the H100: bytes, (T R C + 2 T C + C) * 4 at 3.35 TB/s; each
// charge feeds a handful of float operations.  What bounds it in practice
// depends on T.  The simulator launches T = 1 (one SiMRA of a 65,536-column
// subarray, 2.9 MB): there the kernel is a few microseconds, its launch
// and one trip to memory most of it, so a thread must not wait on several.
// At T = 256 it streams at 88% of the bound.  Design:
//   * R is a template parameter (an instance for the simulator's 8 rows, one
//     that takes R at run time): all R row loads and the noise load are
//     issued before any arithmetic, so a thread waits on one trip to memory;
//   * one thread per (event, column), one event per block row: consecutive
//     threads take consecutive columns, so every row's loads and the output
//     store coalesce into 128-byte lines.  Four columns per thread (float4)
//     and blocks that walk several events measured slower (PERF.md §6):
//     a thread's division and sqrt per column lengthen its critical path,
//     and fewer, longer blocks leave the last wave part empty;
//   * the host makes the launch geometry (kernels/sense.py `plan_launch`:
//     threads, column blocks, event rows past which blocks stride), and the
//     launch checks it; the ragged column edge is masked, so any T and C
//     launch (the TPU kernel's T % 8 and C % 1024 block contract is a TPU
//     tiling rule and is not carried over);
//   * float rules of the calibration kernel: built with -fmad=false, every
//     product and sum rounds on its own, division and sqrt are the
//     round-to-nearest intrinsics, the rows sum in row order, and every
//     constant arrives as the float32 the plain version uses.  One ulp flips
//     a threshold compare, so the result equals the plain version bit for
//     bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

// The host's plan, field order as kernels/sense.py `Plan.FIELDS`.
struct Plan {
  int threads, grid_x, grid_y;
};

struct Consts {
  float c_cell, c_bl_half, c_total, half, two, var_const, st2;
};

// Adds row q into the running charge sum and swing^2 sum (row order).
__device__ __forceinline__ void add_row(float q, float& qsum, float& swing,
                                        const Consts& k) {
  qsum = __fadd_rn(qsum, q);
  const float d = __fmul_rn(k.two, __fsub_rn(q, k.half));
  swing = __fadd_rn(swing, __fmul_rn(d, d));
}

template <int kR>
__global__ void __launch_bounds__(kMaxThreads)
sense_kernel(const float* __restrict__ charge,
             const float* __restrict__ offset,
             const float* __restrict__ noise, float* __restrict__ out, int T,
             int R_rt, int C, Consts k) {
  const int R = kR > 0 ? kR : R_rt;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float thr = __fadd_rn(k.half, __ldg(offset + c));
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const float* q = charge + (int64_t)t * R * C + c;
    const int64_t i = (int64_t)t * C + c;
    float qsum, swing, n;
    if (kR > 0) {
      float rows[kR > 0 ? kR : 1];
#pragma unroll
      for (int r = 0; r < kR; ++r) rows[r] = __ldg(q + (int64_t)r * C);
      n = __ldg(noise + i);
      qsum = rows[0];
      const float d = __fmul_rn(k.two, __fsub_rn(rows[0], k.half));
      swing = __fmul_rn(d, d);
#pragma unroll
      for (int r = 1; r < kR; ++r) add_row(rows[r], qsum, swing, k);
    } else {
      n = __ldg(noise + i);
      qsum = __ldg(q);
      const float d = __fmul_rn(k.two, __fsub_rn(qsum, k.half));
      swing = __fmul_rn(d, d);
      for (int r = 1; r < R; ++r)
        add_row(__ldg(q + (int64_t)r * C), qsum, swing, k);
    }
    const float v = __fdiv_rn(
        __fadd_rn(__fmul_rn(qsum, k.c_cell), k.c_bl_half), k.c_total);
    const float sigma =
        __fsqrt_rn(__fadd_rn(k.var_const, __fmul_rn(k.st2, swing)));
    out[i] = __fadd_rn(v, __fmul_rn(sigma, n)) > thr ? 1.0f : 0.0f;
  }
}

// The plan must cover C with its blocks and fit the grid's event rows.
bool plan_ok(const Plan& p, int T, int C) {
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32)
    return false;
  if ((int64_t)p.grid_x * p.threads < C ||
      (int64_t)(p.grid_x - 1) * p.threads >= C)
    return false;
  return p.grid_y >= 1 && p.grid_y <= T && p.grid_y <= 65535;
}

}  // namespace

extern "C" int simra_sense_launch(const void* charge, const void* offset,
                                  const void* noise, void* out, int T, int R,
                                  int C, float c_cell, float c_bl_half,
                                  float c_total, float half, float two,
                                  float var_const, float st2, const int* plan,
                                  int plan_len, void* stream) {
  if (T < 1 || R < 1 || C < 1 || plan_len != 3)
    return (int)cudaErrorInvalidValue;
  const Plan p{plan[0], plan[1], plan[2]};
  if (!plan_ok(p, T, C)) return (int)cudaErrorInvalidValue;
  const Consts k{c_cell, c_bl_half, c_total, half, two, var_const, st2};
  const dim3 grid(p.grid_x, p.grid_y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (R == 8)
    sense_kernel<8><<<grid, p.threads, 0, st>>>(
        (const float*)charge, (const float*)offset, (const float*)noise,
        (float*)out, T, R, C, k);
  else
    sense_kernel<0><<<grid, p.threads, 0, st>>>(
        (const float*)charge, (const float*)offset, (const float*)noise,
        (float*)out, T, R, C, k);
  return (int)cudaGetLastError();
}
