// Placed bit-plane GEMM/GEMV over bit-packed weight words, for Hopper (sm_90a).
//
// Replaces: repro/kernels/bitplane_gemm.py `bitplane_gemm_placed`
// (pallas_call at bitplane_gemm.py:166) and repro/kernels/bitplane_gemv.py
// `bitplane_gemv_placed` (pallas_call at bitplane_gemv.py:377), both over the
// Pallas body `_gemv_placed_kernel` (bitplane_gemv.py:158).
//
// out[b, n] = sum_k x[b, k] * (sum_p 2^p * bit(words[p, k/8, wcol(n)], k%8)
//                              - 2^(WB-1))
// with wcol(n) = (n / block_cols) * window_block + col_ids[n] % window_block:
// logical column n lives in window block n / block_cols of the physical
// window, at the in-block residue of its placed column id.  int8 activations
// x [B, K], uint8 words [WB, ceil(K/8), W] (eight K rows per byte, LSB
// first), int32 col_ids [N], int32 out [B, N].
//
// Bound on the H100: bytes at decode batch sizes (each weight word is used by
// B rows; at B <= 16 that is far below the card's ops-per-byte balance), and
// integer issue rate at prefill batches.  Design:
//   * a block owns 32 output columns (one per lane) and BT batch rows; its
//     8 warps split the K words between them (word j goes to warp j % 8) and
//     the partial sums meet in shared memory at the end: a split-K with a
//     block reduction, no atomics, so the int32 result is exact and
//     deterministic;
//   * each lane gathers its column's words by plain pointer arithmetic on
//     col_ids (TMA does not fit gathered columns); placed columns are nearly
//     consecutive in the window, so a warp's loads are one or two segments;
//   * the 4-bit offset-binary weights are rebuilt without a per-bit loop:
//     (nibble * 0x00204081) & 0x01010101 spreads a byte's four bits into
//     four bytes, the planes OR in at their shift, and one per-byte subtract
//     of 2^(WB-1) (__vsub4) gives four signed int8 weights in one register.
//     The signed form is exact in int8 for WB <= 8, so no separate
//     offset-binary correction pass over x is needed;
//   * __dp4a multiplies four int8 pairs per instruction into int32;
//   * activations are staged through shared memory 512 K at a time, zero
//     filled past B and K, which masks a ragged batch and a K that is not a
//     multiple of 8 inside the kernel (nothing is padded on the host).
// mode "planes" and "folded" of the reference give the same integers, so one
// kernel serves both.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;        // output columns per block
constexpr int kWarps = 8;         // K-split ways per block
constexpr int kChunkWords = 64;   // K words staged per pass (512 rows of K)

__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

template <int BT>
__global__ void __launch_bounds__(kLanes * kWarps)
placed_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ words,
              const int32_t* __restrict__ col_ids, int32_t* __restrict__ out,
              int B, int K, int Kw, int W, int N, int WB, int window_block,
              int block_cols) {
  __shared__ __align__(16) int8_t xs[BT][kChunkWords * 8];
  __shared__ int32_t red[kWarps][BT][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int n = blockIdx.x * kLanes + lane;
  const int b0 = blockIdx.y * BT;
  const bool live = n < N;

  int64_t wcol = 0;
  if (live) {
    const int blk = n / block_cols;
    wcol = (int64_t)blk * window_block + (col_ids[n] % window_block);
  }
  const int64_t plane_stride = (int64_t)Kw * W;
  const uint32_t off4 = (1u << (WB - 1)) * 0x01010101u;

  int acc[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = 0;

  for (int kw0 = 0; kw0 < Kw; kw0 += kChunkWords) {
    for (int i = threadIdx.x; i < BT * kChunkWords * 8; i += blockDim.x) {
      const int r = i / (kChunkWords * 8);
      const int kk = i - r * (kChunkWords * 8);
      const int b = b0 + r;
      const int k = kw0 * 8 + kk;
      xs[r][kk] = (b < B && k < K) ? x[(int64_t)b * K + k] : (int8_t)0;
    }
    __syncthreads();
    const int n_words = min(kChunkWords, Kw - kw0);
    if (live) {
      for (int j = warp; j < n_words; j += kWarps) {
        const uint8_t* wp = words + (int64_t)(kw0 + j) * W + wcol;
        uint32_t lo = 0, hi = 0;
        for (int p = 0; p < WB; ++p) {
          const uint32_t byte = __ldg(wp + p * plane_stride);
          lo |= spread4(byte & 0xFu) << p;
          hi |= spread4(byte >> 4) << p;
        }
        const int w_lo = (int)__vsub4(lo, off4);   // k = 8j .. 8j+3
        const int w_hi = (int)__vsub4(hi, off4);   // k = 8j+4 .. 8j+7
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int2 xv = *reinterpret_cast<const int2*>(&xs[r][j * 8]);
          acc[r] = __dp4a(xv.x, w_lo, acc[r]);
          acc[r] = __dp4a(xv.y, w_hi, acc[r]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < BT; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < BT * kLanes; i += blockDim.x) {
    const int r = i / kLanes;
    const int l = i - r * kLanes;
    const int nn = blockIdx.x * kLanes + l;
    const int b = b0 + r;
    if (nn < N && b < B) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][r][l];
      out[(int64_t)b * N + nn] = sum;
    }
  }
}

template <int BT>
int launch(const void* x, const void* words, const void* col_ids, void* out,
           int B, int K, int Kw, int W, int N, int WB, int window_block,
           int block_cols, void* stream) {
  if (WB < 1 || WB > 8 || window_block < 1 || block_cols < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kLanes - 1) / kLanes, (B + BT - 1) / BT);
  placed_kernel<BT><<<grid, kLanes * kWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const uint8_t*)words, (const int32_t*)col_ids,
      (int32_t*)out, B, K, Kw, W, N, WB, window_block, block_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch-tiled entry (prefill rows and batched decode): 4-row tiles for
// small batches, 16-row tiles otherwise.
extern "C" int placed_gemm_launch(const void* x, const void* words,
                                  const void* col_ids, void* out, int B, int K,
                                  int Kw, int W, int N, int WB,
                                  int window_block, int block_cols,
                                  void* stream) {
  if (B <= 4)
    return launch<4>(x, words, col_ids, out, B, K, Kw, W, N, WB, window_block,
                     block_cols, stream);
  return launch<16>(x, words, col_ids, out, B, K, Kw, W, N, WB, window_block,
                    block_cols, stream);
}

// Single-row entry (B = 1 decode): one row, the whole block on the split-K.
extern "C" int placed_gemv_launch(const void* x, const void* words,
                                  const void* col_ids, void* out, int B, int K,
                                  int Kw, int W, int N, int WB,
                                  int window_block, int block_cols,
                                  void* stream) {
  if (B != 1) return (int)cudaErrorInvalidValue;
  return launch<1>(x, words, col_ids, out, 1, K, Kw, W, N, WB, window_block,
                   block_cols, stream);
}
