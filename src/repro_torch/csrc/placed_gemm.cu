// Placed bit-plane GEMM/GEMV over bit-packed weight words or dense
// bit-planes, for Hopper (sm_90a).
//
// Replaces: repro/kernels/bitplane_gemm.py `bitplane_gemm_placed`
// (pallas_call at bitplane_gemm.py:166) and repro/kernels/bitplane_gemv.py
// `bitplane_gemv_placed` (pallas_call at bitplane_gemv.py:377), both over the
// Pallas body `_gemv_placed_kernel` (bitplane_gemv.py:158).
//
// out[b, n] = sum_k x[b, k] * (sum_p 2^p * bit(p, k, wcol(n)) - 2^(WB-1))
// with wcol(n) = (n / block_cols) * window_block + col_ids[n] % window_block:
// logical column n lives in window block n / block_cols of the physical
// window, at the in-block residue of its placed column id.  int8 x [B, K],
// int32 col_ids [N], int32 out [B, N]; the window is uint8 words
// [WB, ceil(K/8), W] (eight K rows per byte, LSB first) or, in the dense
// layout, [WB, K, W] bytes of 0/1.  Exact int32, the same in every run.
//
// Bound on the H100: bytes at decode batch sizes (each weight byte feeds B
// rows, far below the card's ops-per-byte balance at B <= 16); at prefill
// batches the integer work, which the int8 tensor cores take.  In practice
// the gather and the bit rebuild (about a dozen integer instructions per
// weight byte and column) bound the decode path before the bytes do.  The
// reference streams one whole window block per grid step and gathers in
// fast memory; this kernel does the same on an SM:
//   * a block owns one window block of logical columns, or an aligned part
//     of one (tile_cols), and stages the window range its columns live in,
//     [WB, stage words, window_block], into a ring of kStages stages in
//     shared memory with 16-byte cp.async.  W is in general not a multiple
//     of 16, so each row's span start is aligned down to 16 bytes and read
//     from its residue, kept in a per-stage row table (TMA's 16-byte stride
//     rule does not hold, so no TMA).  Only 16-byte granules holding a byte
//     of the span are read, so no read leaves the allocation.  Each thread's
//     share of the granules is fixed at block start (copy_plan): the stage
//     loop issues copies with no division.  Each lane then reads its
//     column's byte from shared memory at col_ids[n] % window_block: no
//     single-byte gather reaches device memory.  The dense layout stages
//     its eight K rows per word the same way and folds them into one byte
//     per column in shared memory (pack_dense, four columns per step);
//   * K splits across blocks (gridDim.z) until about two blocks per SM are
//     in flight; the partial sums meet in the output, which the wrapper
//     zeroes, through int32 atomicAdd.  Integer addition is associative, so
//     the result is exact and the same whatever order the blocks finish in.
//     (A cluster reduction in distributed shared memory would save the
//     memset; the atomics are simpler and touch each output K-split times.)
//   * decode rows (B <= 16): __dp4a on CUDA cores.  The 4-bit offset-binary
//     weights are rebuilt without a per-bit loop: (nibble * 0x00204081) &
//     0x01010101 spreads a byte's four bits into four bytes, the planes OR
//     in at their shift, and one per-byte subtract of 2^(WB-1) (__vsub4)
//     gives four signed int8 weights in one register (exact for WB <= 8);
//   * prefill rows (B > 16): each staged stage is unpacked once into a
//     signed int8 tile [128 columns, 8 * stage words] in shared memory and
//     multiplied with all of the block's x rows (64 or 128) by
//     mma.sync.m16n8k32 s8 x s8 -> s32, so each weight is read and unpacked
//     once per block, not once per small row tile;
//   * x rides in the same ring, 16-byte cp.async where K % 16 == 0 and x is
//     aligned, zero filled past B and K (which masks a ragged batch and a K
//     that is not a multiple of 8 inside the kernel).
// A window block too wide to stage (a whole-window pack, never the main
// path) gets a plan with row_bytes 0, and the same kernel reads each lane's
// byte straight from device memory instead.
// The plan (tile, stage words, K split, shared memory, grid, path) is made
// on the host by kernels/placed_gemm.py `plan_launch` and passed in; this
// file only checks it.  mode "planes" and "folded" of the reference give
// the same integers, so one kernel serves both.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kTcCols = 128;    // logical columns of a tensor-core block
constexpr int kPad = 16;        // bytes past 8 * stage words in an int8 row
constexpr int kMaxSmem = 232448;
constexpr int kMaxCopies = 8;   // window granules per thread and stage

// Plan fields, in the order of `Plan.FIELDS` in kernels/placed_gemm.py.
struct Plan {
  int tensor_cores, rows, tile_cols, tiles_per_block, stage_words, stages,
      split_words, n_split, row_bytes, x_row, w_stage, tab_bytes,
      stage_bytes, pk_row, smem_bytes, grid_x, grid_y, grid_z;
};
constexpr int kPlanLen = sizeof(Plan) / sizeof(int);

struct Geom {
  int B, K, Kw, W, N, WB, window_block, block_cols, x_vec;
};

__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

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

// Where one block reads: the window, its span start (window block blk) and
// the window rows per plane (Kw words, or K dense rows).
struct Span {
  const uint8_t* words;
  int64_t start;
  int rpp;
};

// Each thread's share of a stage's window copies, fixed for the whole
// block: copy m of thread t is granule c of stage row q of plane p, packed
// as (p << 16) | (q << 8) | c (-1: none).  The plan keeps a stage within
// kMaxCopies * kThreads granules, so no division is left in the stage loop.
template <bool Dense>
__device__ __forceinline__ void copy_plan(const Geom& G, const Plan& P,
                                          int (&rc)[kMaxCopies]) {
  constexpr int rpw = Dense ? 8 : 1;
  const int ch = P.row_bytes / 16;
  const int total = P.row_bytes ? G.WB * rpw * P.stage_words * ch : 0;
#pragma unroll
  for (int m = 0; m < kMaxCopies; ++m) {
    const int i = threadIdx.x + m * kThreads;
    rc[m] = -1;
    if (i < total) {
      const int r = i / ch;
      const int p = r / (rpw * P.stage_words);
      const int q = r - p * rpw * P.stage_words;
      rc[m] = (p << 16) | (q << 8) | (i - r * ch);
    }
  }
}

// A ring stage: window rows [WB][rpw * KC][row_bytes], x rows
// [rows][x_row], then the row table: tab[r] = r * row_bytes + the row's
// misalignment, the shared offset of the span's first byte.  Window row q
// of plane p is global row kw0 * rpw + q; its 16-byte granules are copied
// from the row's span start aligned down, and only those holding a byte of
// the span.
template <bool Dense>
__device__ __forceinline__ void issue_stage(const Geom& G, const Plan& P,
                                            uint8_t* slot, const Span& sp,
                                            const int8_t* __restrict__ x,
                                            const int (&rc)[kMaxCopies],
                                            int kw0, int b0) {
  constexpr int rpw = Dense ? 8 : 1;
  const int KC = P.stage_words;
  int* tab = reinterpret_cast<int*>(slot + P.w_stage + P.rows * P.x_row);
#pragma unroll
  for (int m = 0; m < kMaxCopies; ++m) {
    if (rc[m] < 0) continue;
    const int p = rc[m] >> 16;
    const int q = (rc[m] >> 8) & 255;
    const int c = rc[m] & 255;
    const int r = p * rpw * KC + q;
    const int grow = kw0 * rpw + q;
    int mis = 0;
    if (grow < sp.rpp) {     // past K the row is not read: x is zero there
      const uintptr_t a = (uintptr_t)(
          sp.words + ((int64_t)p * sp.rpp + grow) * G.W + sp.start);
      mis = (int)(a & 15);
      if (c * 16 < mis + G.window_block)
        cp16(slot + r * P.row_bytes + c * 16,
             (const void*)((a & ~(uintptr_t)15) + c * 16), 16);
    }
    if (c == 0) tab[r] = r * P.row_bytes + mis;
  }
  int8_t* xs = (int8_t*)(slot + P.w_stage);
  const int xk = 8 * KC;
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

// Dense layout: fold each word's eight staged 0/1 rows into one byte per
// column, pk[(p * KC + j) * pk_row + t], four columns per step (two aligned
// 32-bit reads and a funnel shift per row undo the row's misalignment).
__device__ __forceinline__ void pack_dense(const Geom& G, const Plan& P,
                                           const uint8_t* slot, uint8_t* pk) {
  const int* tab =
      reinterpret_cast<const int*>(slot + P.w_stage + P.rows * P.x_row);
  const int q4 = (G.window_block + 3) / 4;
  const int n = G.WB * P.stage_words * q4;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int pj = i / q4;                 // p * KC + j
    const int t = (i - pj * q4) * 4;
    const int* rt = tab + pj * 8;          // its rows: 8 (p * KC + j) + jj
    uint32_t w = 0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int off = rt[jj] + t;
      const uint32_t* a =
          reinterpret_cast<const uint32_t*>(slot + (off & ~3));
      w |= (__funnelshift_r(a[0], a[1], 8 * (off & 3)) & 0x01010101u)
           << jj;
    }
    *reinterpret_cast<uint32_t*>(pk + pj * P.pk_row + t) = w;
  }
}

// Byte of plane p, K word kw at in-span column res, read straight from the
// window (a span too wide to stage).  Dense: the word's eight 0/1 rows.
template <bool Dense>
__device__ __forceinline__ uint32_t direct_byte(const Geom& G, const Span& sp,
                                                int p, int kw, int res) {
  if (!Dense)
    return kw < G.Kw ? __ldg(sp.words + ((int64_t)p * G.Kw + kw) * G.W +
                             sp.start + res)
                     : 0u;
  uint32_t byte = 0;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int k = kw * 8 + jj;
    if (k < G.K)
      byte |= ((uint32_t)__ldg(sp.words + ((int64_t)p * G.K + k) * G.W +
                               sp.start + res) & 1u) << jj;
  }
  return byte;
}

// Signed int8 weights of K rows 8 kw .. 8 kw + 3 (lo) and + 4 .. + 7 (hi)
// of stage word j at in-span column res.  Staged: src is the thread's
// column in the stage (packed words, rows at tab[p * KC + j]) or in the
// folded dense words (rows pk_row apart); otherwise the window itself.
template <bool Dense, bool Staged>
__device__ __forceinline__ void weights(const Geom& G, const Plan& P,
                                        const uint8_t* src, const int* tab,
                                        const Span& sp, int j, int kw,
                                        int res, int& w_lo, int& w_hi) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (p >= G.WB) break;
    const int pj = p * P.stage_words + j;
    const uint32_t byte =
        !Staged ? direct_byte<Dense>(G, sp, p, kw, res)
                : (Dense ? src[pj * P.pk_row] : src[tab[pj]]);
    lo |= spread4(byte & 0xFu) << p;
    hi |= spread4(byte >> 4) << p;
  }
  const uint32_t off4 = (1u << (G.WB - 1)) * 0x01010101u;
  w_lo = (int)__vsub4(lo, off4);
  w_hi = (int)__vsub4(hi, off4);
}

// One stage of the decode path: words ks, ks + ksub, .. < nw of the stage
// against BT staged x rows.
template <int BT, bool Dense, bool Staged>
__device__ __forceinline__ void dp4a_stage(const Geom& G, const Plan& P,
                                           const uint8_t* src,
                                           const int* tab, const int8_t* xs,
                                           const Span& sp, int kw0, int nw,
                                           int ks, int ksub, int res,
                                           int (&acc)[BT]) {
  for (int j = ks; j < nw; j += ksub) {
    int w_lo, w_hi;
    weights<Dense, Staged>(G, P, src, tab, sp, j, kw0 + j, res, w_lo, w_hi);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int2 xv =
          *reinterpret_cast<const int2*>(xs + r * P.x_row + j * 8);
      acc[r] = __dp4a(xv.x, w_lo, acc[r]);
      acc[r] = __dp4a(xv.y, w_hi, acc[r]);
    }
  }
}

// One stage of the prefill path: unpack every (column, word) of the stage
// once into the signed int8 tile wt [128][wt_row].
template <bool Dense, bool Staged>
__device__ __forceinline__ void unpack_stage(const Geom& G, const Plan& P,
                                             const uint8_t* base,
                                             const int* tab, const Span& sp,
                                             const int* res_s, uint8_t* wt,
                                             int wt_row, int kw0,
                                             int kw_end) {
  for (int i = threadIdx.x; i < kTcCols * P.stage_words; i += kThreads) {
    const int cc = i % kTcCols;
    const int j = i / kTcCols;
    const int res = res_s[cc];
    int w_lo = 0, w_hi = 0;
    if (res >= 0 && kw0 + j < kw_end)
      weights<Dense, Staged>(G, P, Staged ? base + res : base, tab, sp, j,
                             kw0 + j, res,
                             w_lo, w_hi);
    *reinterpret_cast<int2*>(wt + cc * wt_row + j * 8) =
        make_int2(w_lo, w_hi);
  }
}

__device__ __forceinline__ void put(int32_t* out, int64_t i, int v,
                                    bool atomic) {
  if (atomic) atomicAdd(out + i, v);
  else out[i] = v;
}

// Block coordinates shared by both paths.
struct Tile {
  int blk, t, b0, kw_begin, kw_end, n_stages;
};

__device__ __forceinline__ Tile tile_of(const Geom& G, const Plan& P) {
  Tile T;
  T.blk = blockIdx.x / P.tiles_per_block;
  T.t = blockIdx.x - T.blk * P.tiles_per_block;
  T.b0 = blockIdx.y * P.rows;
  T.kw_begin = blockIdx.z * P.split_words;
  T.kw_end = min(G.Kw, T.kw_begin + P.split_words);
  T.n_stages = (T.kw_end - T.kw_begin + P.stage_words - 1) / P.stage_words;
  return T;
}

__device__ __forceinline__ Span span_of(const Geom& G, const uint8_t* words,
                                        int blk, bool dense) {
  return Span{words, (int64_t)blk * G.window_block, dense ? G.K : G.Kw};
}

// The folded dense words live past the ring.
__device__ __forceinline__ uint8_t* pk_of(uint8_t* smem, const Plan& P) {
  return smem + kStages * P.stage_bytes + 16;
}

// Decode path: one lane per column (tile_cols 256), or 256 / tile_cols
// lanes per column splitting each stage's words; BT batch rows.
template <int BT, bool Dense>
__global__ void __launch_bounds__(kThreads)
dp4a_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ words,
            const int32_t* __restrict__ col_ids, int32_t* __restrict__ out,
            Geom G, Plan P) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile T = tile_of(G, P);
  const Span sp = span_of(G, words, T.blk, Dense);
  const int tile = P.tile_cols;
  const int c = threadIdx.x % tile;
  const int ks = threadIdx.x / tile;
  const int ksub = kThreads / tile;
  const int cl = T.t * tile + c;
  const bool live = cl < G.block_cols;
  const int n = T.blk * G.block_cols + cl;
  const int res = live ? col_ids[n] % G.window_block : 0;
  const int KC = P.stage_words;
  uint8_t* pk = pk_of(smem, P);

  int rc[kMaxCopies];
  copy_plan<Dense>(G, P, rc);
  int acc[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = 0;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T.n_stages)
      issue_stage<Dense>(G, P, smem + s * P.stage_bytes, sp, x, rc,
                         T.kw_begin + s * KC, T.b0);
    cp_commit();
  }
#pragma unroll 1
  for (int s = 0; s < T.n_stages; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = s + kStages - 1;
    if (nxt < T.n_stages)
      issue_stage<Dense>(G, P, smem + (nxt % kStages) * P.stage_bytes, sp,
                         x, rc, T.kw_begin + nxt * KC, T.b0);
    cp_commit();
    const uint8_t* slot = smem + (s % kStages) * P.stage_bytes;
    if (Dense && P.row_bytes) {
      pack_dense(G, P, slot, pk);
      __syncthreads();
    }
    const int8_t* xs = (const int8_t*)(slot + P.w_stage);
    const int kw0 = T.kw_begin + s * KC;
    const int nw = min(KC, T.kw_end - kw0);
    const int* tab =
        reinterpret_cast<const int*>(slot + P.w_stage + P.rows * P.x_row);
    if (live) {
      if (P.row_bytes)
        dp4a_stage<BT, Dense, true>(G, P, (Dense ? pk : slot) + res, tab, xs,
                                    sp, kw0, nw, ks, ksub, res, acc);
      else
        dp4a_stage<BT, Dense, false>(G, P, nullptr, tab, xs, sp, kw0, nw, ks,
                                     ksub, res, acc);
    }
  }
  cp_wait<0>();
  __syncthreads();

  const bool atomic = P.n_split > 1;
  if (ksub == 1) {
    if (live)
#pragma unroll
      for (int r = 0; r < BT; ++r)
        if (T.b0 + r < G.B)
          put(out, (int64_t)(T.b0 + r) * G.N + n, acc[r], atomic);
    return;
  }
  int* red = reinterpret_cast<int*>(smem);   // [ksub][BT][tile]
#pragma unroll
  for (int r = 0; r < BT; ++r) red[(ks * BT + r) * tile + c] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < BT * tile; i += kThreads) {
    const int r = i / tile;
    const int cc = i - r * tile;
    const int cl2 = T.t * tile + cc;
    if (cl2 >= G.block_cols || T.b0 + r >= G.B) continue;
    int sum = 0;
    for (int q = 0; q < ksub; ++q) sum += red[(q * BT + r) * tile + cc];
    put(out, (int64_t)(T.b0 + r) * G.N + T.blk * G.block_cols + cl2, sum,
        atomic);
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Prefill path: 128 columns x 32 MT rows per block; 8 warps as 2 (rows) x
// 4 (columns), each warp MT x 4 tiles of m16n8.
template <int MT, bool Dense>
__global__ void __launch_bounds__(kThreads, 2)
mma_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ words,
           const int32_t* __restrict__ col_ids, int32_t* __restrict__ out,
           Geom G, Plan P) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile T = tile_of(G, P);
  const Span sp = span_of(G, words, T.blk, Dense);
  const int KC = P.stage_words;
  const int wt_row = 8 * KC + kPad;
  uint8_t* pk = pk_of(smem, P);
  uint8_t* wt = pk + G.WB * KC * P.pk_row;          // [128][wt_row] int8
  int* res_s = reinterpret_cast<int*>(wt + kTcCols * wt_row);
  for (int i = threadIdx.x; i < kTcCols; i += kThreads) {
    const int cl = T.t * kTcCols + i;
    res_s[i] = cl < G.block_cols
                   ? col_ids[T.blk * G.block_cols + cl] % G.window_block
                   : -1;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  int rc[kMaxCopies];
  copy_plan<Dense>(G, P, rc);
  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T.n_stages)
      issue_stage<Dense>(G, P, smem + s * P.stage_bytes, sp, x, rc,
                         T.kw_begin + s * KC, T.b0);
    cp_commit();
  }
#pragma unroll 1
  for (int s = 0; s < T.n_stages; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = s + kStages - 1;
    if (nxt < T.n_stages)
      issue_stage<Dense>(G, P, smem + (nxt % kStages) * P.stage_bytes, sp,
                         x, rc, T.kw_begin + nxt * KC, T.b0);
    cp_commit();
    const uint8_t* slot = smem + (s % kStages) * P.stage_bytes;
    if (Dense && P.row_bytes) {
      pack_dense(G, P, slot, pk);
      __syncthreads();
    }
    const int kw0 = T.kw_begin + s * KC;
    // unpack the stage once into the signed int8 tile
    const int* tab =
        reinterpret_cast<const int*>(slot + P.w_stage + P.rows * P.x_row);
    if (P.row_bytes)
      unpack_stage<Dense, true>(G, P, Dense ? pk : slot, tab, sp, res_s, wt,
                                wt_row, kw0, T.kw_end);
    else
      unpack_stage<Dense, false>(G, P, nullptr, tab, sp, res_s, wt, wt_row,
                                 kw0, T.kw_end);
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
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* col = wt + (wn * 32 + nt * 8 + g) * wt_row + kb +
                             tig * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
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
        const int b = T.b0 + wm * MT * 16 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int cl = T.t * kTcCols + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (b < G.B && cl < G.block_cols)
          put(out, (int64_t)b * G.N + T.blk * G.block_cols + cl,
              acc[mt][nt][e], atomic);
      }
}

template <typename K>
int run(K kernel, const Plan& P, const Geom& G, const void* x,
        const void* words, const void* col_ids, void* out, void* stream) {
  if (P.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(P.grid_x, P.grid_y, P.grid_z), kThreads, P.smem_bytes,
           (cudaStream_t)stream>>>((const int8_t*)x, (const uint8_t*)words,
                                   (const int32_t*)col_ids, (int32_t*)out, G,
                                   P);
  return (int)cudaGetLastError();
}

template <bool Dense>
int dispatch(const Plan& P, const Geom& G, const void* x, const void* words,
             const void* col_ids, void* out, void* stream) {
#define RUN(KERNEL) return run(KERNEL, P, G, x, words, col_ids, out, stream)
  if (P.tensor_cores) {
    if (P.rows == 64) RUN((mma_kernel<2, Dense>));
    RUN((mma_kernel<4, Dense>));
  }
  switch (P.rows) {
    case 1: RUN((dp4a_kernel<1, Dense>));
    case 4: RUN((dp4a_kernel<4, Dense>));
    case 8: RUN((dp4a_kernel<8, Dense>));
    default: RUN((dp4a_kernel<16, Dense>));
  }
#undef RUN
}

// The plan's invariants that the kernels rely on.
bool plan_ok(const Plan& P, const Geom& G, int dense) {
  const int rpw = dense ? 8 : 1;
  const int KC = P.stage_words;
  const int tiles = (G.block_cols + P.tile_cols - 1) / P.tile_cols;
  const bool staged = P.row_bytes != 0;
  int need_smem = kStages * P.stage_bytes + 16 + G.WB * KC * P.pk_row;
  if (P.tensor_cores)
    need_smem += kTcCols * (8 * KC + kPad) + kTcCols * 4;
  else if (P.tile_cols < kThreads && kThreads * P.rows * 4 > need_smem)
    need_smem = kThreads * P.rows * 4;
  const bool rows_ok = P.tensor_cores
                           ? (P.rows == 64 || P.rows == 128) &&
                                 P.tile_cols == kTcCols && KC % 4 == 0
                           : (P.rows == 1 || P.rows == 4 || P.rows == 8 ||
                              P.rows == 16) &&
                                 (P.tile_cols == 64 || P.tile_cols == 128 ||
                                  P.tile_cols == 256);
  const bool staged_ok =
      staged ? P.row_bytes >= G.window_block + 15 && P.row_bytes % 16 == 0 &&
                   P.w_stage == G.WB * rpw * KC * P.row_bytes &&
                   P.tab_bytes >= 4 * G.WB * rpw * KC &&
                   G.WB * rpw * KC * (P.row_bytes / 16) <=
                       kMaxCopies * kThreads &&
                   P.row_bytes / 16 <= 256 &&
                   (dense ? P.pk_row >= G.window_block + 3 &&
                                P.pk_row % 16 == 0
                          : P.pk_row == 0)
             : P.w_stage == 0 && P.tab_bytes == 0 && P.pk_row == 0;
  return rows_ok && staged_ok && P.stages == kStages && KC >= 1 &&
         P.split_words >= KC && P.split_words % KC == 0 &&
         P.n_split == (G.Kw + P.split_words - 1) / P.split_words &&
         P.tiles_per_block == tiles && P.x_row >= 8 * KC &&
         P.x_row % 16 == 0 && P.tab_bytes % 16 == 0 &&
         P.stage_bytes == P.w_stage + P.rows * P.x_row + P.tab_bytes &&
         P.smem_bytes >= need_smem && P.smem_bytes <= kMaxSmem &&
         P.grid_x == (G.N / G.block_cols) * tiles &&
         P.grid_y == (G.B + P.rows - 1) / P.rows && P.grid_z == P.n_split;
}

int launch(const void* x, const void* words, const void* col_ids, void* out,
           int B, int K, int Kw, int W, int N, int WB, int window_block,
           int block_cols, int dense, const int* plan, int plan_len,
           void* stream) {
  if (plan_len != kPlanLen || WB < 1 || WB > 8 || window_block < 1 ||
      block_cols < 1 || B < 1 || N < 1 || N % block_cols ||
      W != (N / block_cols) * window_block || K > Kw * 8 ||
      K <= (Kw - 1) * 8)
    return (int)cudaErrorInvalidValue;
  Plan P;
  int* f = reinterpret_cast<int*>(&P);
  for (int i = 0; i < kPlanLen; ++i) f[i] = plan[i];
  Geom G{B, K, Kw, W, N, WB, window_block, block_cols, 0};
  G.x_vec = K % 16 == 0 && P.stage_words % 2 == 0 &&
            (uintptr_t)x % 16 == 0;
  if (!plan_ok(P, G, dense)) return (int)cudaErrorInvalidValue;
  return dense ? dispatch<true>(P, G, x, words, col_ids, out, stream)
               : dispatch<false>(P, G, x, words, col_ids, out, stream);
}

}  // namespace

// Batch entry (prefill rows and batched decode).  dense != 0: words are a
// dense window [WB, K, W] (Kw = ceil(K / 8) still counts the K words).
// plan: `Plan.FIELDS` of kernels/placed_gemm.py.  out must be zeroed when
// the plan splits K (n_split > 1).
extern "C" int placed_gemm_launch(const void* x, const void* words,
                                  const void* col_ids, void* out, int B, int K,
                                  int Kw, int W, int N, int WB,
                                  int window_block, int block_cols, int dense,
                                  const int* plan, int plan_len,
                                  void* stream) {
  return launch(x, words, col_ids, out, B, K, Kw, W, N, WB, window_block,
                block_cols, dense, plan, plan_len, stream);
}

// Single-row entry (B = 1 decode): the one-row dp4a plan only.
extern "C" int placed_gemv_launch(const void* x, const void* words,
                                  const void* col_ids, void* out, int B, int K,
                                  int Kw, int W, int N, int WB,
                                  int window_block, int block_cols, int dense,
                                  const int* plan, int plan_len,
                                  void* stream) {
  if (B != 1 || plan_len < 2 || plan[0] != 0 || plan[1] != 1)
    return (int)cudaErrorInvalidValue;
  return launch(x, words, col_ids, out, 1, K, Kw, W, N, WB, window_block,
                block_cols, dense, plan, plan_len, stream);
}
