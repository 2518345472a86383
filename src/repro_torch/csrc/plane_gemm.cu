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
// order: no gather map.  The dense layout, planes [WB, K, N] of one 0/1 byte
// per bit (int8, the reference's default), is read by the same kernels
// (nothing is repacked on the host or in a pass of its own).  Dense planes
// are 8x the bytes of words.
//
// Bound on the H100: bytes at decode batch sizes (every weight byte feeds B
// rows; at B <= 16 that is far below the card's ops-per-byte balance), and
// the integer work at prefill batches, which the int8 tensor cores take.
// Both paths share:
//   * a block owns 128 contiguous output columns and stages, per step of
//     KC K words, [WB, rpw * KC, 128 columns] of weight rows (rpw = 8 dense
//     rows per word, else 1) and [rows, 8 KC] of x into a ring of kStages
//     in shared memory with 16-byte cp.async (issue_stage), so that three
//     stages are in flight while one is computed;
//   * K splits across blocks (gridDim.z), in whole stages, until about two
//     blocks per SM are in flight; the partial sums meet in the output,
//     which the wrapper zeroes, through int32 atomicAdd.  Integer addition
//     is associative, so the result is exact and the same whatever order
//     the blocks finish in.  With one split the block stores its sums and
//     nothing is zeroed;
//   * the offset-binary weights are rebuilt four K rows of one column to a
//     32-bit word of signed int8, the layout __dp4a and the K-contiguous
//     `.col` B fragment read.  The signed form is exact in int8 for
//     WB <= 8, so the reference's separate `_sign_fix` pass over x is not
//     needed.
// Decode rows (B <= 16, `plane_kernel`): a lane owns four adjacent columns
// and the block's 8 warps take a stage's units of work in turn (a K word,
// or four dense K rows); their sums meet in shared memory at the end, and
// __dp4a multiplies four int8 pairs per instruction.  The plane count is a
// template parameter (instances for WB 4, every main-path pack, and 8; one
// takes WB at run time), so only real planes are read and the offset folds
// to a constant.  Rebuild, with no per-bit loop: the dense rows of four
// columns add up over the planes at their shift (0/1 bytes, no carry) and
// a 4 x 4 byte transpose (__byte_perm) gives each column its four K rows;
// bit-packed words gather per column into an 8 x 8 bit matrix by the same
// byte transpose and three delta swaps transpose it.  to_signed then takes
// 2^(WB-1) off every byte in two instructions.
// Prefill rows (B >= 17, `plane_mma_kernel`): a block owns 64 or 128 x rows;
// each stage is unpacked once into a signed int8 tile (the nibble spread
// (nibble * 0x00204081) & 0x01010101 per plane, a per-byte __vsub4; K-quad
// rows of 136 words: one column's four K values per 32-bit word, the
// K-contiguous layout the `.col` B fragment reads, conflict-free for the
// 16-byte unpack stores and the fragment loads) and multiplied with all of
// the block's x rows by mma.sync.m16n8k32 s8 x s8 -> s32; the 8 warps sit
// as 2 (rows) x 4 (columns).  So each weight is read and unpacked once per
// block, not once per 16 rows.
// Both mask a ragged batch, a K that is not a multiple of 8 and a ragged N
// inside the kernel (zero-filled x rows and weight columns); nothing is
// padded on the host.  Alignment rule: weight rows load as 16-byte cp.async
// when N % 16 == 0 and the words start 16-byte aligned (then every
// 16-column granule is wholly inside or wholly past N), and x rows when
// K % 16 == 0 and x is 16-byte aligned; otherwise that operand is staged
// byte by byte (masked, synchronous) in the same kernel.
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
constexpr int kWarps = kThreads / kLanes;          // dp4a: ways a stage splits
constexpr int kStages = 4;                         // ring depth (both paths)
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

// Offset-binary bytes v (each below 2^WB) to signed int8 bytes
// v - 2^(WB-1): adding 128 - 2^(WB-1) keeps every byte below 256 (no
// carry into the next), and the XOR with 0x80 takes 128 back off in two's
// complement.
__device__ __forceinline__ uint32_t to_signed(uint32_t v, int wb) {
  return (v + (128u - (1u << (wb - 1))) * 0x01010101u) ^ 0x80808080u;
}

// 4 x 4 byte transpose: byte i of the new r[c] is byte c of the old r[i]
// (rows of four columns in, columns of four rows out).
__device__ __forceinline__ void transpose4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}


// Delta swap: exchanges the bits of x under m with those k places up.
__device__ __forceinline__ uint32_t swap_bits(uint32_t x, int k, uint32_t m) {
  const uint32_t t = (x ^ (x >> k)) & m;
  return x ^ t ^ (t << k);
}

// The bit-packed decode rebuild: raw[p] holds word kw of plane p for four
// adjacent columns (byte c: column c, bit i: K row 8 kw + i).  A byte
// transpose gathers each column's plane bytes into an 8 x 8 bit matrix
// (byte p: plane p, in l for planes 0-3 and h for 4-7); three delta swaps
// transpose it (Hacker's Delight 7-3), which puts K row i in byte i with
// plane p at bit p: the offset-binary weight, made signed by to_signed.
// lo[c]: rows 8 kw .. 8 kw + 3 of column c, hi[c]: rows + 4 .. + 7.  kP
// planes are read (planes past WB are zero); with kP <= 4 the upper half
// is zero and its swaps fold away.
template <int kP>
__device__ __forceinline__ void rebuild_t(const uint32_t (&raw)[8], int WB,
                                          uint32_t (&lo)[kColsPerLane],
                                          uint32_t (&hi)[kColsPerLane]) {
  uint32_t l[4] = {raw[0], raw[1], raw[2], raw[3]};
  uint32_t h[4] = {0u, 0u, 0u, 0u};
  transpose4(l);
  if (kP > 4) {
#pragma unroll
    for (int p = 0; p < 4; ++p) h[p] = raw[4 + p];
    transpose4(h);
  }
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    uint32_t a = swap_bits(swap_bits(l[c], 7, 0x00AA00AAu), 14, 0x0000CCCCu);
    uint32_t b = 0;
    if (kP > 4)
      b = swap_bits(swap_bits(h[c], 7, 0x00AA00AAu), 14, 0x0000CCCCu);
    const uint32_t t = (a ^ (b << 4)) & 0xF0F0F0F0u;
    lo[c] = to_signed(a ^ t, WB);
    hi[c] = to_signed(b ^ (t >> 4), WB);
  }
}

// --------------------------------------------------------------- staging --

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

// ---------------------------------------------------------------- decode --

// The uint32 at column quad `lane` (four adjacent columns) of staged row q.
__device__ __forceinline__ uint32_t lds4(const uint8_t* slot, int q,
                                         int lane) {
  return *reinterpret_cast<const uint32_t*>(slot + q * kTileCols + 4 * lane);
}

// BT x rows by 128 columns (four adjacent ones a lane) over one K split;
// weight rows and x rows run through the ring of kStages stages that the
// prefill path uses (issue_stage).  A stage's units of work, a K word of
// the bit-packed layout or four K rows of the dense one, go to the 8 warps
// in turn; the warps' partial sums meet in shared memory at the end.
// WBc: the plane count compiled in, 0 for WB at run time.
template <int BT, int WBc, bool Dense>
__global__ void __launch_bounds__(kThreads)
plane_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ words,
             int32_t* __restrict__ out, Geom G, Plan P) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kP = WBc ? WBc : 8;   // planes unrolled
  const int WB = WBc ? WBc : G.WB;
  const int KC = P.stage_words;
  const int n0 = blockIdx.x * kTileCols;
  const int b0 = blockIdx.y * BT;
  const int kw_begin = blockIdx.z * P.split_words;
  const int kw_end = min(G.Kw, kw_begin + P.split_words);
  const int n_stages = (kw_end - kw_begin + KC - 1) / KC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int acc[BT][kColsPerLane];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0;

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
    const int8_t* xs = (const int8_t*)(slot + P.w_stage);
    const int units = (Dense ? 2 : 1) * min(KC, kw_end - kw_begin - s * KC);
#pragma unroll 1
    for (int u = warp; u < units; u += kWarps) {
      if (Dense) {
        // Rows 4u .. 4u + 3 of the stage: each row's four columns with the
        // planes added in at their shift (0/1 bytes: no carry), then a
        // byte transpose gives each column its four K rows.
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = 0;
#pragma unroll
          for (int p = 0; p < kP; ++p)
            if (WBc || p < WB)
              v[i] += lds4(slot, p * 8 * KC + 4 * u + i, lane) << p;
        }
        transpose4(v);
        uint32_t w[kColsPerLane];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) w[c] = to_signed(v[c], WB);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int xv =
              *reinterpret_cast<const int*>(xs + r * P.x_row + 4 * u);
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c)
            acc[r][c] = __dp4a(xv, (int)w[c], acc[r][c]);
        }
      } else {
        // K word u of the stage, rows 8u .. 8u + 7.
        uint32_t raw[8];
#pragma unroll
        for (int p = 0; p < 8; ++p)
          raw[p] = p < kP && (WBc || p < WB) ? lds4(slot, p * KC + u, lane)
                                             : 0u;
        uint32_t lo[kColsPerLane], hi[kColsPerLane];
        rebuild_t<kP>(raw, WB, lo, hi);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int2 xv =
              *reinterpret_cast<const int2*>(xs + r * P.x_row + 8 * u);
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            acc[r][c] = __dp4a(xv.x, (int)lo[c], acc[r][c]);
            acc[r][c] = __dp4a(xv.y, (int)hi[c], acc[r][c]);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // One batch row at a time through the ring's memory: [kWarps][128].
  int* red = reinterpret_cast<int*>(smem);
  const bool atomic = P.n_split > 1;
  const int n = n0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    *reinterpret_cast<int4*>(red + warp * kTileCols + lane * kColsPerLane) =
        make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    if (threadIdx.x < kTileCols && n < G.N && b0 + r < G.B) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w * kTileCols + threadIdx.x];
      put(out, (int64_t)(b0 + r) * G.N + n, sum, atomic);
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------- prefill --

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
int run(Kern kernel, const Plan& P, const Geom& G, const void* x,
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

// The compiled plane counts: 4 (every main-path pack) and 8; any other WB
// runs the run-time instance.
template <int BT, bool Dense>
int run_dp4a(const Plan& P, const Geom& G, const void* x, const void* words,
             void* out, cudaStream_t s) {
  switch (G.WB) {
    case 4: return run(plane_kernel<BT, 4, Dense>, P, G, x, words, out, s);
    case 8: return run(plane_kernel<BT, 8, Dense>, P, G, x, words, out, s);
    default: return run(plane_kernel<BT, 0, Dense>, P, G, x, words, out, s);
  }
}

template <bool Dense>
int dispatch(const Plan& P, const Geom& G, const void* x, const void* words,
             void* out, cudaStream_t s) {
  if (P.tensor_cores) {
    if (P.rows == 64)
      return run(plane_mma_kernel<2, Dense>, P, G, x, words, out, s);
    return run(plane_mma_kernel<4, Dense>, P, G, x, words, out, s);
  }
  switch (P.rows) {
    case 1: return run_dp4a<1, Dense>(P, G, x, words, out, s);
    case 4: return run_dp4a<4, Dense>(P, G, x, words, out, s);
    default: return run_dp4a<16, Dense>(P, G, x, words, out, s);
  }
}

// The plan's invariants that the kernels rely on.
bool plan_ok(const Plan& P, const Geom& G, int dense) {
  const int KC = P.stage_words;
  const int rpw = dense ? 8 : 1;
  const bool common =
      P.split_words >= KC && P.split_words % KC == 0 &&
      P.n_split == (G.Kw + P.split_words - 1) / P.split_words &&
      P.grid_x == (G.N + kTileCols - 1) / kTileCols &&
      P.grid_y == (G.B + P.rows - 1) / P.rows && P.grid_z == P.n_split &&
      (KC == 4 || KC == 8 || KC == 16 || KC == 32) && P.stages == kStages &&
      P.x_row == 8 * KC + kPad && P.w_stage == G.WB * rpw * KC * kTileCols &&
      P.stage_bytes == P.w_stage + P.rows * P.x_row &&
      P.smem_bytes <= kMaxSmem;
  if (!P.tensor_cores)
    return common && (P.rows == 1 || P.rows == 4 || P.rows == 16) &&
           (dense ? 2 : 1) * KC >= kWarps &&
           P.smem_bytes >= kStages * P.stage_bytes &&
           P.smem_bytes >= kWarps * kTileCols * 4;
  return common && (P.rows == 64 || P.rows == 128) && KC <= 16 &&
         P.smem_bytes >= kStages * P.stage_bytes + 2 * KC * kWtStride * 4;
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
