// Unplaced bit-plane GEMM/GEMV over bit-packed weight words, for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/bitplane_gemm.py `bitplane_gemm` (pallas_call at
// bitplane_gemm.py:105) and repro/kernels/bitplane_gemv.py `bitplane_gemv`
// (pallas_call at bitplane_gemv.py:316), both over the Pallas body
// `_gemv_kernel` (bitplane_gemv.py:139) with `_unpack_bits`, `_accumulate`
// and the offset-binary correction `_sign_fix`.
//
// out[b, n] = sum_k x[b, k] * (sum_p 2^p * bit(words[p, k/8, n], k%8)
//                              - 2^(WB-1))
// int8 activations x [B, K], uint8 words [WB, ceil(K/8), N] (eight K rows
// per byte, LSB first), int32 out [B, N].  Columns are the logical ones, in
// order: no gather map.
//
// Bound on the H100: bytes at decode batch sizes (every weight byte feeds B
// rows; at B <= 16 that is far below the card's ops-per-byte balance), and
// integer issue rate at prefill batches.  Design:
//   * contiguous columns, so a lane owns four adjacent ones and a warp reads
//     one 128-byte line of words per plane and K word (the placed kernel
//     gathers and reads 32 bytes per warp);
//   * a block owns 128 columns and BT batch rows; its 8 warps split its K
//     words (word j goes to warp j % 8) and meet in shared memory;
//   * where those blocks would not fill the card (decode shapes: N = 2048
//     gives 16 column tiles), gridDim.z splits K further across blocks and
//     each block adds its partial sums into the zeroed output with integer
//     atomics.  Integer addition is associative, so the result is exact and
//     the same whatever order the blocks finish in;
//   * the 4-bit offset-binary weights are rebuilt without a per-bit loop:
//     (nibble * 0x00204081) & 0x01010101 spreads a byte's four bits into
//     four bytes, the planes OR in at their shift, and one per-byte subtract
//     of 2^(WB-1) (__vsub4) gives four signed int8 weights in one register.
//     The signed form is exact in int8 for WB <= 8, so the reference's
//     separate `_sign_fix` pass over x is not needed;
//   * __dp4a multiplies four int8 pairs per instruction into int32;
//   * activations are staged through shared memory 512 K at a time, zero
//     filled past B and K, which masks a ragged batch and a K that is not a
//     multiple of 8 inside the kernel (nothing is padded on the host); a
//     ragged N is masked per column.
// mode "planes" and "folded" of the reference give the same integers, so one
// kernel serves both.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kColsPerLane = 4;
constexpr int kTileCols = kLanes * kColsPerLane;   // output columns per block
constexpr int kWarps = 8;                          // K-split ways per block
constexpr int kChunkWords = 64;                    // K words staged per pass

__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// Vec: the four words of a lane load as one aligned uint32 (N % 4 == 0 and
// an aligned base); otherwise byte by byte, masked at N.
template <int BT, bool Vec>
__global__ void __launch_bounds__(kLanes * kWarps)
plane_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ words,
             int32_t* __restrict__ out, int B, int K, int Kw, int N, int WB,
             int split_words) {
  __shared__ __align__(16) int8_t xs[BT][kChunkWords * 8];
  __shared__ __align__(16) int32_t red[kWarps][kTileCols];

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int n0 = blockIdx.x * kTileCols + lane * kColsPerLane;
  const int b0 = blockIdx.y * BT;
  const int kw_begin = blockIdx.z * split_words;
  const int kw_end = min(Kw, kw_begin + split_words);
  const int64_t plane_stride = (int64_t)Kw * N;
  const uint32_t off4 = (1u << (WB - 1)) * 0x01010101u;

  int acc[BT][kColsPerLane];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0;

  for (int kw0 = kw_begin; kw0 < kw_end; kw0 += kChunkWords) {
    for (int i = threadIdx.x; i < BT * kChunkWords * 8; i += blockDim.x) {
      const int r = i / (kChunkWords * 8);
      const int kk = i - r * (kChunkWords * 8);
      const int b = b0 + r;
      const int k = kw0 * 8 + kk;
      xs[r][kk] = (b < B && k < K) ? x[(int64_t)b * K + k] : (int8_t)0;
    }
    __syncthreads();
    const int n_words = min(kChunkWords, kw_end - kw0);
    if (n0 < N) {
      for (int j = warp; j < n_words; j += kWarps) {
        const uint8_t* wp = words + (int64_t)(kw0 + j) * N + n0;
        uint32_t raw[8];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          raw[p] = 0;
          if (p < WB) {
            if (Vec) {
              raw[p] = __ldg(reinterpret_cast<const uint32_t*>(
                  wp + p * plane_stride));
            } else {
#pragma unroll
              for (int c = 0; c < kColsPerLane; ++c)
                if (n0 + c < N)
                  raw[p] |= (uint32_t)__ldg(wp + p * plane_stride + c)
                            << (8 * c);
            }
          }
        }
        int w_lo[kColsPerLane], w_hi[kColsPerLane];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          uint32_t lo = 0, hi = 0;
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const uint32_t byte = (raw[p] >> (8 * c)) & 0xFFu;
            lo |= spread4(byte & 0xFu) << p;
            hi |= spread4(byte >> 4) << p;
          }
          w_lo[c] = (int)__vsub4(lo, off4);   // k = 8j .. 8j+3
          w_hi[c] = (int)__vsub4(hi, off4);   // k = 8j+4 .. 8j+7
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int2 xv = *reinterpret_cast<const int2*>(&xs[r][j * 8]);
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            acc[r][c] = __dp4a(xv.x, w_lo[c], acc[r][c]);
            acc[r][c] = __dp4a(xv.y, w_hi[c], acc[r][c]);
          }
        }
      }
    }
    __syncthreads();
  }

  // One batch row at a time through shared memory (all BT rows at once
  // would need 64 KB at BT = 16).
  const int n = blockIdx.x * kTileCols + threadIdx.x;
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    *reinterpret_cast<int4*>(&red[warp][lane * kColsPerLane]) =
        make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    if (threadIdx.x < kTileCols && n < N && b0 + r < B) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][threadIdx.x];
      atomicAdd(out + (int64_t)(b0 + r) * N + n, sum);
    }
    __syncthreads();
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

// out must be zeroed: every block adds its partial sums into it.
template <int BT>
int launch(const void* x, const void* words, void* out, int B, int K, int Kw,
           int N, int WB, void* stream) {
  if (WB < 1 || WB > 8 || B < 1 || N < 1 || Kw < 1 || K > Kw * 8)
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (N + kTileCols - 1) / kTileCols;
  const int tiles_b = (B + BT - 1) / BT;
  const int chunks = (Kw + kChunkWords - 1) / kChunkWords;
  // Split K across blocks until there are about two blocks per SM.
  const int64_t tiles = (int64_t)tiles_n * tiles_b;
  const int64_t want = (2 * (int64_t)sm_count() + tiles - 1) / tiles;
  const int split = (int)(want < chunks ? (want < 1 ? 1 : want) : chunks);
  const int split_words = ((chunks + split - 1) / split) * kChunkWords;
  const int n_split = (Kw + split_words - 1) / split_words;
  dim3 grid(tiles_n, tiles_b, n_split);
  const bool vec = (N % 4 == 0) && ((uintptr_t)words % 4 == 0);
  auto s = (cudaStream_t)stream;
  if (vec)
    plane_kernel<BT, true><<<grid, kLanes * kWarps, 0, s>>>(
        (const int8_t*)x, (const uint8_t*)words, (int32_t*)out, B, K, Kw, N,
        WB, split_words);
  else
    plane_kernel<BT, false><<<grid, kLanes * kWarps, 0, s>>>(
        (const int8_t*)x, (const uint8_t*)words, (int32_t*)out, B, K, Kw, N,
        WB, split_words);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch-tiled entry (prefill rows and batched decode): 4-row tiles for
// small batches, 16-row tiles otherwise.  out must be zeroed.
extern "C" int plane_gemm_launch(const void* x, const void* words, void* out,
                                 int B, int K, int Kw, int N, int WB,
                                 void* stream) {
  if (B <= 4) return launch<4>(x, words, out, B, K, Kw, N, WB, stream);
  return launch<16>(x, words, out, B, K, Kw, N, WB, stream);
}

// Single-row entry (B = 1 decode).  out must be zeroed.
extern "C" int plane_gemv_launch(const void* x, const void* words, void* out,
                                 int B, int K, int Kw, int N, int WB,
                                 void* stream) {
  if (B != 1) return (int)cudaErrorInvalidValue;
  return launch<1>(x, words, out, 1, K, Kw, N, WB, stream);
}
