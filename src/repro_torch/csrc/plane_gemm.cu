// Unplaced bit-plane GEMM/GEMV over bit-packed weight words or dense
// bit-planes, for Hopper (sm_90a).
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
// order: no gather map.  The dense layout, planes [WB, K, N] of one byte per
// bit (int8 0/1, the reference's default), is a template parameter of the
// load path only: the eight K rows of a word are read from the dense planes,
// each byte masked to its low bit and shifted into the bit the packed word
// would hold it in, so every operation after the load is the one the packed
// path runs (nothing is repacked on the host or in a pass of its own).
// Dense planes are 8x the bytes of words.
//
// Bound on the H100: bytes at decode batch sizes (every weight byte feeds B
// rows; at B <= 16 that is far below the card's ops-per-byte balance), and
// the integer work at prefill batches, which the int8 tensor cores take.
// Both paths share:
//   * a block owns 128 contiguous output columns, so a warp reads whole
//     128-byte lines of words (the placed kernel gathers);
//   * K splits across blocks (gridDim.z) until about two blocks per SM are
//     in flight; the partial sums meet in the output, which the wrapper
//     zeroes, through int32 atomicAdd.  Integer addition is associative, so
//     the result is exact and the same whatever order the blocks finish in.
//     With one split the block stores its sums and nothing is zeroed;
//   * the 4-bit offset-binary weights are rebuilt without a per-bit loop:
//     (nibble * 0x00204081) & 0x01010101 spreads a byte's four bits into
//     four bytes, the planes OR in at their shift, and one per-byte subtract
//     of 2^(WB-1) (__vsub4) gives four signed int8 weights of one column and
//     four consecutive K rows in one register.  The signed form is exact in
//     int8 for WB <= 8, so the reference's separate `_sign_fix` pass over x
//     is not needed.
// Decode rows (B <= 16, `plane_kernel`): a lane owns four adjacent columns,
// the block's 8 warps split its K words (word j to warp j % 8) and meet in
// shared memory; x is staged 512 K at a time; __dp4a multiplies four int8
// pairs per instruction.
// Prefill rows (B >= 17, `plane_mma_kernel`): a block owns 64 or 128 x rows
// and stages [WB, KC words, 128 columns] of weights and [rows, 8 KC] of x
// per stage into a ring of kStages in shared memory with 16-byte cp.async;
// each stage is unpacked once into a signed int8 tile (K-quad rows of 136
// words: one column's four K values per 32-bit word, the K-contiguous
// layout the `.col` B fragment reads, conflict-free for the 16-byte
// unpack stores and the fragment loads) and multiplied with all of the
// block's x rows by mma.sync.m16n8k32 s8 x s8 -> s32; the 8 warps sit as
// 2 (rows) x 4 (columns).  So each weight is read and unpacked once per
// block, not once per 16 rows.
// Both mask a ragged batch, a K that is not a multiple of 8 and a ragged N
// inside the kernel (zero-filled x rows and weight columns); nothing is
// padded on the host.  Alignment rule of the prefill path: weight rows load
// as 16-byte cp.async when N % 16 == 0 and the words start 16-byte aligned
// (then every 16-column granule is wholly inside or wholly past N), and x
// rows when K % 16 == 0 and x is 16-byte aligned; otherwise that operand is
// staged byte by byte (masked, synchronous) in the same kernel.
// The plan (path, rows, stage words, K split, shared memory, grid) is made
// on the host by kernels/plane_gemm.py `plan_launch` from the shapes and
// the device's SM count, and passed in; this file only checks it.  mode
// "planes" and "folded" of the reference give the same integers, so one
// kernel serves both.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kColsPerLane = 4;
constexpr int kTileCols = kLanes * kColsPerLane;   // output columns per block
constexpr int kWarps = kThreads / kLanes;          // K-split ways (dp4a)
constexpr int kChunkWords = 64;                    // dp4a: K words per pass
constexpr int kStages = 4;                         // tensor cores: ring depth
constexpr int kPad = 16;          // bytes past 8 * stage words in an x row
constexpr int kWtStride = kTileCols + 8;   // 32-bit words per int8-tile row
constexpr int kMaxSmem = 232448;

// Plan fields, in the order of `Plan.FIELDS` in kernels/plane_gemm.py.
struct Plan {
  int tensor_cores, rows, stage_words, stages, split_words, n_split, x_row,
      w_stage, stage_bytes, smem_bytes, grid_x, grid_y, grid_z;
};
constexpr int kPlanLen = sizeof(Plan) / sizeof(int);

struct Geom {
  int B, K, Kw, N, WB, x_vec, w_vec;
};

__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// Signed int8 weights of four columns from their planes' bytes: raw[p]
// holds word kw of plane p for four adjacent columns (byte c: column c).
// lo[c]: K rows 8 kw .. 8 kw + 3 of column c, hi[c]: rows + 4 .. + 7.
__device__ __forceinline__ void rebuild4(const uint32_t (&raw)[8], int WB,
                                         uint32_t (&lo)[kColsPerLane],
                                         uint32_t (&hi)[kColsPerLane]) {
  const uint32_t off4 = (1u << (WB - 1)) * 0x01010101u;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    uint32_t l = 0, h = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint32_t byte = (raw[p] >> (8 * c)) & 0xFFu;
      l |= spread4(byte & 0xFu) << p;
      h |= spread4(byte >> 4) << p;
    }
    lo[c] = __vsub4(l, off4);
    hi[c] = __vsub4(h, off4);
  }
}

__device__ __forceinline__ void put(int32_t* out, int64_t i, int v,
                                    bool atomic) {
  if (atomic) atomicAdd(out + i, v);
  else out[i] = v;
}

// ---------------------------------------------------------------- decode --

// Four adjacent bytes at p; byte by byte (masked at `left` columns) unless
// Vec, where they load as one aligned uint32.
template <bool Vec>
__device__ __forceinline__ uint32_t ld4(const uint8_t* p, int left) {
  if (Vec) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c)
    if (c < left) v |= (uint32_t)__ldg(p + c) << (8 * c);
  return v;
}

// K word kw of four adjacent columns n0.. of one plane: byte c holds rows
// 8 kw .. 8 kw + 7 of column n0 + c, LSB first.  Packed: the stored word.
// Dense: eight rows of 0/1 bytes, rows at or past K read as zero.
template <bool Vec, bool Dense>
__device__ __forceinline__ uint32_t load_word4(const uint8_t* plane, int kw,
                                               int K, int N, int n0) {
  if (!Dense) return ld4<Vec>(plane + (int64_t)kw * N + n0, N - n0);
  uint32_t w = 0;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int k = kw * 8 + jj;
    if (k < K)
      w |= (ld4<Vec>(plane + (int64_t)k * N + n0, N - n0) & 0x01010101u)
           << jj;
  }
  return w;
}

// Vec: the four words of a lane load as one aligned uint32 (N % 4 == 0 and
// an aligned base); otherwise byte by byte, masked at N.  Dense: the planes
// are [WB, K, N] bytes instead of [WB, Kw, N] words.
template <int BT, bool Vec, bool Dense>
__global__ void __launch_bounds__(kThreads)
plane_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ words,
             int32_t* __restrict__ out, int B, int K, int Kw, int N, int WB,
             int split_words, bool atomic) {
  __shared__ __align__(16) int8_t xs[BT][kChunkWords * 8];
  __shared__ __align__(16) int32_t red[kWarps][kTileCols];

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int n0 = blockIdx.x * kTileCols + lane * kColsPerLane;
  const int b0 = blockIdx.y * BT;
  const int kw_begin = blockIdx.z * split_words;
  const int kw_end = min(Kw, kw_begin + split_words);
  const int64_t plane_stride = (int64_t)(Dense ? K : Kw) * N;

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
        uint32_t raw[8];
#pragma unroll
        for (int p = 0; p < 8; ++p)
          raw[p] = p < WB ? load_word4<Vec, Dense>(words + p * plane_stride,
                                                   kw0 + j, K, N, n0)
                          : 0u;
        uint32_t w_lo[kColsPerLane], w_hi[kColsPerLane];
        rebuild4(raw, WB, w_lo, w_hi);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int2 xv = *reinterpret_cast<const int2*>(&xs[r][j * 8]);
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            acc[r][c] = __dp4a(xv.x, (int)w_lo[c], acc[r][c]);
            acc[r][c] = __dp4a(xv.y, (int)w_hi[c], acc[r][c]);
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
      put(out, (int64_t)(b0 + r) * N + n, sum, atomic);
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------- prefill --

__device__ __forceinline__ void cp16(void* smem, const void* gmem,
                                     int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One ring stage: weight rows [WB][rpw * KC][128 columns] (rpw = 8 dense
// rows per word, else 1), then x rows [rows][x_row].  Weight row q of plane
// p is global row kw0 * rpw + q of that plane, at columns n0 .. n0 + 127;
// rows at or past the plane's end and columns at or past N are zero.  x is
// zero past B and K.
template <bool Dense>
__device__ __forceinline__ void issue_stage(const Geom& G, const Plan& P,
                                            uint8_t* slot,
                                            const uint8_t* __restrict__ words,
                                            const int8_t* __restrict__ x,
                                            int kw0, int b0, int n0) {
  constexpr int rpw = Dense ? 8 : 1;
  const int rows_pp = rpw * P.stage_words;   // a power of two
  const int shift = __ffs(rows_pp) - 1;
  const int rpp = Dense ? G.K : G.Kw;        // rows per plane
  const int n_rows = G.WB * rows_pp;
  if (G.w_vec) {
    for (int i = threadIdx.x; i < n_rows * (kTileCols / 16); i += kThreads) {
      const int r = i >> 3;
      const int c = i & 7;
      const int p = r >> shift;
      const int grow = kw0 * rpw + (r & (rows_pp - 1));
      const int n = n0 + c * 16;
      const bool ok = grow < rpp && n < G.N;
      cp16(slot + r * kTileCols + c * 16,
           ok ? words + ((int64_t)p * rpp + grow) * G.N + n : words,
           ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * kTileCols; i += kThreads) {
      const int r = i >> 7;
      const int c = i & (kTileCols - 1);
      const int p = r >> shift;
      const int grow = kw0 * rpw + (r & (rows_pp - 1));
      const int n = n0 + c;
      slot[r * kTileCols + c] =
          grow < rpp && n < G.N
              ? __ldg(words + ((int64_t)p * rpp + grow) * G.N + n)
              : (uint8_t)0;
    }
  }
  int8_t* xs = (int8_t*)(slot + P.w_stage);
  const int xk = 8 * P.stage_words;
  const int k0 = kw0 * 8;
  if (G.x_vec) {
    const int ch = xk / 16;
    for (int i = threadIdx.x; i < P.rows * ch; i += kThreads) {
      const int r = i / ch;
      const int c = i - r * ch;
      const int b = b0 + r;
      const int k = k0 + c * 16;
      const bool ok = b < G.B && k < G.K;
      cp16(xs + r * P.x_row + c * 16, ok ? x + (int64_t)b * G.K + k : x,
           ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < P.rows * xk; i += kThreads) {
      const int r = i / xk;
      const int kk = i - r * xk;
      const int b = b0 + r;
      const int k = k0 + kk;
      xs[r * P.x_row + kk] =
          (b < G.B && k < G.K) ? x[(int64_t)b * G.K + k] : (int8_t)0;
    }
  }
}

// Unpack a stage once into the signed int8 tile wt: row kq (K rows
// 4 kq .. 4 kq + 3 of the stage) holds one 32-bit word per column.  Item
// (j, cq) rebuilds word j of columns 4 cq .. 4 cq + 3 and stores two
// 16-byte rows: lanes take consecutive column quads, so the shared reads
// of the staged rows and the stores are conflict-free.
template <bool Dense>
__device__ __forceinline__ void unpack_stage(const Geom& G, const Plan& P,
                                             const uint8_t* slot,
                                             uint32_t* wt) {
  const int KC = P.stage_words;
  for (int i = threadIdx.x; i < kLanes * KC; i += kThreads) {
    const int cq = i & (kLanes - 1);
    const int j = i >> 5;
    uint32_t raw[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      raw[p] = 0;
      if (p >= G.WB) continue;
      if (!Dense) {
        raw[p] = *reinterpret_cast<const uint32_t*>(
            slot + (p * KC + j) * kTileCols + 4 * cq);
      } else {
        const uint8_t* r0 = slot + (p * 8 * KC + 8 * j) * kTileCols + 4 * cq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          raw[p] |= (*reinterpret_cast<const uint32_t*>(r0 + jj * kTileCols) &
                     0x01010101u) << jj;
      }
    }
    uint32_t lo[kColsPerLane], hi[kColsPerLane];
    rebuild4(raw, G.WB, lo, hi);
    *reinterpret_cast<uint4*>(wt + (2 * j) * kWtStride + 4 * cq) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(wt + (2 * j + 1) * kWtStride + 4 * cq) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// 128 columns x 32 MT rows per block; 8 warps as 2 (rows) x 4 (columns),
// each warp MT x 4 tiles of m16n8.
template <int MT, bool Dense>
__global__ void __launch_bounds__(kThreads, 2)
plane_mma_kernel(const int8_t* __restrict__ x,
                 const uint8_t* __restrict__ words,
                 int32_t* __restrict__ out, Geom G, Plan P) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int KC = P.stage_words;
  uint32_t* wt = reinterpret_cast<uint32_t*>(smem + kStages * P.stage_bytes);
  const int n0 = blockIdx.x * kTileCols;
  const int b0 = blockIdx.y * P.rows;
  const int kw_begin = blockIdx.z * P.split_words;
  const int kw_end = min(G.Kw, kw_begin + P.split_words);
  const int n_stages = (kw_end - kw_begin + KC - 1) / KC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages)
      issue_stage<Dense>(G, P, smem + s * P.stage_bytes, words, x,
                         kw_begin + s * KC, b0, n0);
    cp_commit();
  }
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = s + kStages - 1;
    if (nxt < n_stages)
      issue_stage<Dense>(G, P, smem + (nxt % kStages) * P.stage_bytes, words,
                         x, kw_begin + nxt * KC, b0, n0);
    cp_commit();
    const uint8_t* slot = smem + (s % kStages) * P.stage_bytes;
    unpack_stage<Dense>(G, P, slot, wt);
    __syncthreads();
    const int8_t* xs = (const int8_t*)(slot + P.w_stage);
    for (int kb = 0; kb < 8 * KC; kb += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* r0 = xs + (wm * MT * 16 + mt * 16 + g) * P.x_row + kb +
                           tig * 4;
        const int8_t* r8 = r0 + 8 * P.x_row;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
      const uint32_t* w0 = wt + (kb / 4 + tig) * kWtStride + wn * 32 + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t b0v = w0[nt * 8];
        const uint32_t b1v = w0[4 * kWtStride + nt * 8];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0v, b1v);
      }
    }
  }
  cp_wait<0>();

  const bool atomic = P.n_split > 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = b0 + wm * MT * 16 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (b < G.B && n < G.N)
          put(out, (int64_t)b * G.N + n, acc[mt][nt][e], atomic);
      }
}

// ---------------------------------------------------------------- launch --

template <typename Kern>
int run_mma(Kern kernel, const Plan& P, const Geom& G, const void* x,
            const void* words, void* out, cudaStream_t s) {
  if (P.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(P.grid_x, P.grid_y, P.grid_z), kThreads, P.smem_bytes, s>>>(
      (const int8_t*)x, (const uint8_t*)words, (int32_t*)out, G, P);
  return (int)cudaGetLastError();
}

template <int BT, bool Dense>
int run_dp4a(const Plan& P, const Geom& G, bool vec, const void* x,
             const void* words, void* out, cudaStream_t s) {
  const dim3 grid(P.grid_x, P.grid_y, P.grid_z);
  const bool atomic = P.n_split > 1;
  if (vec)
    plane_kernel<BT, true, Dense><<<grid, kThreads, 0, s>>>(
        (const int8_t*)x, (const uint8_t*)words, (int32_t*)out, G.B, G.K,
        G.Kw, G.N, G.WB, P.split_words, atomic);
  else
    plane_kernel<BT, false, Dense><<<grid, kThreads, 0, s>>>(
        (const int8_t*)x, (const uint8_t*)words, (int32_t*)out, G.B, G.K,
        G.Kw, G.N, G.WB, P.split_words, atomic);
  return (int)cudaGetLastError();
}

template <bool Dense>
int dispatch(const Plan& P, const Geom& G, const void* x, const void* words,
             void* out, cudaStream_t s) {
  if (P.tensor_cores) {
    if (P.rows == 64)
      return run_mma(plane_mma_kernel<2, Dense>, P, G, x, words, out, s);
    return run_mma(plane_mma_kernel<4, Dense>, P, G, x, words, out, s);
  }
  // dp4a: four adjacent columns load as one uint32 (N % 4 == 0 and an
  // aligned base), else byte by byte.
  const bool vec = (G.N % 4 == 0) && ((uintptr_t)words % 4 == 0);
  switch (P.rows) {
    case 1: return run_dp4a<1, Dense>(P, G, vec, x, words, out, s);
    case 4: return run_dp4a<4, Dense>(P, G, vec, x, words, out, s);
    default: return run_dp4a<16, Dense>(P, G, vec, x, words, out, s);
  }
}

// The plan's invariants that the kernels rely on.
bool plan_ok(const Plan& P, const Geom& G, int dense) {
  const int KC = P.stage_words;
  const bool common =
      P.split_words >= KC && KC >= 1 && P.split_words % KC == 0 &&
      P.n_split == (G.Kw + P.split_words - 1) / P.split_words &&
      P.grid_x == (G.N + kTileCols - 1) / kTileCols &&
      P.grid_y == (G.B + P.rows - 1) / P.rows && P.grid_z == P.n_split;
  if (!P.tensor_cores)
    return common && (P.rows == 1 || P.rows == 4 || P.rows == 16) &&
           KC == kChunkWords;
  const int rpw = dense ? 8 : 1;
  return common && (P.rows == 64 || P.rows == 128) &&
         (KC == 4 || KC == 8 || KC == 16) && P.stages == kStages &&
         P.x_row == 8 * KC + kPad &&
         P.w_stage == G.WB * rpw * KC * kTileCols &&
         P.stage_bytes == P.w_stage + P.rows * P.x_row &&
         P.smem_bytes >= kStages * P.stage_bytes + 2 * KC * kWtStride * 4 &&
         P.smem_bytes <= kMaxSmem;
}

int launch(const void* x, const void* words, void* out, int B, int K, int Kw,
           int N, int WB, int dense, const int* plan, int plan_len,
           void* stream) {
  if (plan_len != kPlanLen || WB < 1 || WB > 8 || B < 1 || N < 1 || K < 1 ||
      K > Kw * 8 || K <= (Kw - 1) * 8)
    return (int)cudaErrorInvalidValue;
  Plan P;
  int* f = reinterpret_cast<int*>(&P);
  for (int i = 0; i < kPlanLen; ++i) f[i] = plan[i];
  Geom G{B, K, Kw, N, WB, 0, 0};
  G.x_vec = K % 16 == 0 && (uintptr_t)x % 16 == 0;
  G.w_vec = N % 16 == 0 && (uintptr_t)words % 16 == 0;
  if (!plan_ok(P, G, dense)) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return dense ? dispatch<true>(P, G, x, words, out, s)
               : dispatch<false>(P, G, x, words, out, s);
}

}  // namespace

// Batch entry (prefill rows and batched decode).  dense != 0: words are
// dense planes [WB, K, N] (Kw = ceil(K / 8) still counts the K words).
// plan: `Plan.FIELDS` of kernels/plane_gemm.py.  out must be zeroed when
// the plan splits K (n_split > 1).
extern "C" int plane_gemm_launch(const void* x, const void* words, void* out,
                                 int B, int K, int Kw, int N, int WB,
                                 int dense, const int* plan, int plan_len,
                                 void* stream) {
  return launch(x, words, out, B, K, Kw, N, WB, dense, plan, plan_len,
                stream);
}

// Single-row entry (B = 1 decode): the one-row dp4a plan only.
extern "C" int plane_gemv_launch(const void* x, const void* words, void* out,
                                 int B, int K, int Kw, int N, int WB,
                                 int dense, const int* plan, int plan_len,
                                 void* stream) {
  if (B != 1 || plan_len < 2 || plan[0] != 0 || plan[1] != 1)
    return (int)cudaErrorInvalidValue;
  return launch(x, words, out, 1, K, Kw, N, WB, dense, plan, plan_len,
                stream);
}
