// The two kernels of an ALS half-step, written for Hopper (sm_90a):
//
//   assemble_kernel         replaces predictionio_tpu/ops/als_pallas.py::
//                           assemble_normal_equations (kernel _kernel),
//                           also under the config grid's vmap; at any rank
//                           (its tile-group route)
//   spd_solve_warp_kernel   replaces predictionio_tpu/ops/als_pallas.py::
//   spd_solve_block_kernel  spd_solve (kernel _spd_solve_kernel): one warp
//                           a system, or one block above the ranks where
//                           two warps' workspaces fit a block
//
// assemble_kernel. For each solve row b with slots l < L it gathers
// y_l = Y[cols[b, l]] and writes
//   A[b] = gram + sum_l aw[b, l] * y_l y_l^T      b[b] = sum_l bw[b, l] * y_l
// in fp32 FMAs (no tensor cores, no TF32: the reference pins
// Precision.HIGHEST). Nothing [B, L, R]-sized ever reaches device
// memory: each block gathers its slots' factor rows into shared memory,
// which is what the TPU kernel's VMEM gather bought. Rank is taken as
// given (the TPU kernel padded it to 128 for DMA alignment), up to what
// one block's threads hold one tile each (pio_assemble_max_rank: 208 on an
// H100); above that the host launches its tile-group route (below).
// Y is fp32 or bf16 (the bf16 training precision's factor store, the
// bf16 lane of predictionio_tpu/ops/als.py::_solve_rows): the kernels are
// templated on the factor type, a bf16 row is converted to fp32 as it is
// gathered (exactly: a bf16 value is the top half of an fp32 one), and
// everything after the gather is the fp32 route's arithmetic, so the bf16
// route on Y equals the fp32 route on Y.float() bit for bit.
// Bound on this card: slots * (R(R+1) + 2R) fp32 operations at 67
// TFLOP/s (A is symmetric: one FMA per upper-triangle entry per slot)
// against Y read once (M * R * bytes(Y); it fits in L2), the [B, L]
// tables and the A/b outputs at 3.35 TB/s; at R = 64 the operations bind
// for all but the shortest rows. What the design does about it:
// - Long rows are split. A row of L slots is ceil(L / span) blocks
//   (span = 2,048 from the wrapper), so the few item rows of 10^4-10^5
//   slots under power-law popularity fill the card instead of leaving a
//   tail of one block each; each block writes a partial [R*R + R], and
//   assemble_reduce_kernel adds gram and the partials in span order, so
//   the result is deterministic (no float atomics).
// - Only the upper triangle is summed: RT(RT+1)/2 of the RT x RT tiles
//   of 8 x 8 (36 of 64 at R = 64), mirrored as A is written.
// - Each thread holds one 8 x 8 tile in registers and takes its 16 inputs
//   per slot as four 16-byte shared-memory loads: 64 FMAs for 5 loads.
//   Four groups of threads sum disjoint slots; their tiles are added in
//   group order at the end. Stripes of 8 entries of b are items of their
//   own, so b costs no extra pass.
// - The block stages its whole slice of (cols, aw, bw), at most 2,048
//   slots, in shared memory once, so no chunk waits on a device-memory
//   load, and stops after the last chunk that holds a live slot.
// - The gather is double-buffered with one barrier a chunk: warp 0
//   compacts each 64-slot chunk's live slots (padding is neither gathered
//   nor summed) and the next chunk's factor rows arrive by cp.async while
//   this one is summed. A bf16 row cannot take cp.async into the fp32
//   tile (it is converted on the way, and at an odd rank its rows are not
//   4-byte aligned): its threads load it through registers (16 bytes, 8
//   values, a load when R % 8 == 0 and Y is 16-byte aligned, else one
//   value a load) and store it converted before they sum the chunk before
//   it. The shared tile, and so the largest rank, is the fp32 route's.
// - The tensor cores are not used. A 3xTF32 version (mma.sync m16n8k8,
//   which keeps fp32 accuracy) was slower on an H100: the kernel waits on
//   its gathers and barriers far more than on its FMAs.
// - The config grid (several hyperparameter configurations of one solve
//   side, the JAX package's vmap over a config axis) is one launch: the
//   config is blockIdx.y, and each block offsets Y, aw, bw, gram, A, b and
//   the partials by its config's strides (CfgStrides); cols is shared.
//   Each config's block does exactly what the single-config launch's
//   does, so its sums come out bitwise equal to its own launch, and no
//   scratch is shared between configs (a NaN stays in its lane). The
//   single-config entry is the grid entry at K = 1.
// - The tile-group route (kParts) takes any rank: A's tiles fall into
//   bands of at most 20 tiles (160 columns), and each diagonal band, and
//   each pair of bands (cut into two halves of its rows above 256 tiles),
//   is a block of its own (a "part", blockIdx.x % band_parts) with its
//   tiles and, on the diagonal, its rows' stripes of b. The block gathers
//   only its part's segments of each factor row (at most 256 columns),
//   32 slots a chunk, so its shared memory (96 KB) does not grow with the
//   rank and two blocks (16 warps) share an SM. One slot group: each part
//   sums its slots in slot order, so an entry's sum is the same whichever
//   part holds it, and the spans' partials and assemble_reduce_kernel are
//   the main route's. A task is 3 blocks at R = 256 (two of 152 items,
//   one of 256), 4 at R = 320 (230, 200, 200, 230); every part re-stages
//   the row's (cols, aw, bw) slice and gathers its own segments.
//
// spd_solve_warp_kernel. One warp solves one system A x = b: non-pivoted
// Cholesky A = U^T U on the upper triangle, with the pivot clamped at
// max(d, 1e-30) as in the TPU kernel, then U^T y = b and U x = y by
// column sweeps. The warp first copies A's upper triangle into its
// workspace in shared memory, packed row by row, with every load in
// flight at once; U then overwrites it in place. The factorization is
// up-looking: row i of U is
// summed in registers (lane l holds columns w + l + 32m, m < 8, of a
// 256-column window from the 32-column group w that holds the diagonal;
// a longer row loops over windows) from a_ij and the rows k < i of U, the
// k loop running over the window's column groups inside the matrix alone.
// Rows go in pairs, which share each u_kj the k loop loads. The sweeps
// keep v in registers (this kernel takes R <= 256). Every entry takes the
// plain version's operations in its order, each product rounded before
// its subtraction (__fmul_rn / __fsub_rn, no FMA contraction), so the
// result is bitwise equal to it. No block barrier: lanes meet at
// __syncwarp and shuffles. The workspace, solve_ws_floats(R) = T(R) + R
// floats (R = 64: 8.6 KB), holds the packed upper triangle (the last R
// are v's room in the block route's layout); the host's plan takes this
// kernel while two or more fit a block (R <= 239 on an H100). The TPU
// kernel's batch-on-lanes layout is a TPU device and is not copied.
//
// spd_solve_block_kernel. Above that one warp alone walked R^3 / 6
// dependent products through its workspace, with ~10 warps an SM. Here
// 16 warps share one system, whose workspace (132,608 bytes at R = 256,
// 206,720 at 320) fits a block's shared memory up to R = 339: for each
// 32 rows, one warp a row pair takes every step k of the rows before
// them, then the 32 rows are finished pair by pair over the column
// groups, so every entry keeps the warp kernel's sequence (bitwise equal
// to the plain version) while 16 warps sum at once (see the kernel).
// Above R = 339 the same
// kernel keeps the workspace in device memory, one slot per block of a
// grid of at most two blocks an SM, so only memory limits the rank.
// Bound on this card: B * (R(R+1)/2 + 2R) * 4 bytes (the upper triangle
// of A, b and x) at 3.35 TB/s against B * (R^3/3 + 2R^2) fp32
// operations; the bytes bind below R of about 120, the operations above.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int ASM_CHUNK = 64;        // slots gathered into shared memory at a time
constexpr int ASM_GROUPS = 4;        // slot groups: group g sums live slots g, g+4, ...
constexpr int ASM_MAX_THREADS = 384;
constexpr int ASM_SMALL_THREADS = 192;  // up to here three blocks share an SM
constexpr int ASM_META = 3;          // chunks of (cols, aw, bw) in flight
constexpr int ASM_SLICE = 2048;      // most (col, aw, bw) slots a block stages at its start
constexpr int REDUCE_THREADS = 256;
constexpr int BAND_MAX = 20;         // tile-group route: most tiles of 8 a band
constexpr int PART_CHUNK = 32;       // ... its slots gathered at a time
constexpr int PART_THREADS = 256;    // ... the most items (threads) of a part
constexpr int SOLVE_MAX_WARPS = 8;   // spd_solve_warp_kernel: warps (systems) a block
constexpr int SOLVE_BLOCK_WARPS = 16;  // spd_solve_block_kernel: warps of one system's block
constexpr int SOLVE_SCALARS = 8;     // ... its pivot scalars (two slots of 4), after the workspace
constexpr int SOLVE_CHUNK = 256;     // ... columns of a row one pass covers
constexpr int SOLVE_MC = SOLVE_CHUNK / 32;  // ... 8 of them a lane

// The geometry of one assembly block at rank R: RT x RT tiles of 8 x 8,
// of which the `tiles` on or above the diagonal are summed, and RT
// stripes of 8 entries of b; each of these `items` by `groups` threads
// over disjoint slots.
struct AsmShape {
  int rs;      // the row stride of a gathered chunk (R rounded up to 8, skewed)
  int rt;      // tiles per side
  int tiles;   // rt (rt + 1) / 2
  int items;   // tiles + rt
  int groups;  // slot groups
  int workers; // items * groups threads sum; the rest, up to a whole warp, only gather
  int threads;
  size_t smem_bytes;
};

// Per-config element strides of a grid launch (several configurations
// of one solve side in one launch, the config in blockIdx.y): config z
// reads Y + z * y, aw / bw + z * w and gram + z * gram, and writes A + z
// * a and b + z * b (in the split mode A and b are the partials'
// scratch). The tables' cols are shared. A single-config launch has
// gridDim.y = 1, so z = 0: every pointer is the launch's own.
struct CfgStrides {
  long long y, w, gram, a, b;
};

// Where column c of a gathered factor row sits in shared memory: four
// spare floats after every 32, so the 16-byte loads of the tiles' 8-column
// segments at c and c + 32 fall in different banks.
__host__ __device__ inline int skew(int c) { return c + 4 * (c >> 5); }

inline AsmShape asm_shape(int R) {
  AsmShape s;
  s.rt = (R + 7) / 8;
  s.rs = (skew(8 * s.rt - 1) + 4) & ~3;
  s.tiles = s.rt * (s.rt + 1) / 2;
  s.items = s.tiles + s.rt;
  s.groups = 1;  // a power of two, so a chunk splits evenly between grouped rows
  while (2 * s.groups <= std::min(ASM_GROUPS, ASM_MAX_THREADS / s.items)) s.groups *= 2;
  if (s.items > ASM_MAX_THREADS) s.groups = 0;
  s.workers = s.items * s.groups;
  s.threads = (s.workers + 31) / 32 * 32;  // warp 0's ballots need a whole warp
  const size_t ys = 2 * static_cast<size_t>(ASM_CHUNK) * s.rs;
  const size_t red = static_cast<size_t>(std::max(s.groups - 1, 0)) * s.items * 64;
  s.smem_bytes =
      (std::max(ys, red) + ASM_META * (3 * ASM_CHUNK + ASM_GROUPS) + 4 + 3 * ASM_SLICE) *
      sizeof(float);
  return s;
}

// The tile-group route (any rank): A's RT x RT tiles fall into nb bands
// of nt tiles a side (nb = ceil(RT / BAND_MAX), nt = ceil(RT / nb)), and
// each part, a block of its own, is a rectangle of tile rows [r0, r1) x
// tile columns [c0, c1): a diagonal band (its tiles on or above the
// diagonal, and its rows' stripes of b), or an off-diagonal pair of
// bands, cut into two halves of its rows when its nt * nt tiles would
// exceed PART_THREADS. Parts are numbered band by band: the diagonal,
// then the pairs to its right.
struct Part {
  int r0, r1, c0, c1;
  bool diag;
};

__host__ __device__ inline int band_count(int rt) { return (rt + BAND_MAX - 1) / BAND_MAX; }
__host__ __device__ inline int band_tiles(int rt) {
  const int nb = band_count(rt);
  return (rt + nb - 1) / nb;
}
__host__ __device__ inline int band_halves(int rt) {
  const int nt = band_tiles(rt);
  return nt * nt > PART_THREADS ? 2 : 1;
}
__host__ __device__ inline int band_parts(int rt) {
  const int nb = band_count(rt);
  return nb + nb * (nb - 1) / 2 * band_halves(rt);
}

__host__ __device__ inline Part part_of(int rt, int part) {
  const int nb = band_count(rt), nt = band_tiles(rt), sp = band_halves(rt);
  for (int I = 0; I < nb; ++I) {
    const int a0 = I * nt, a1 = (I + 1) * nt < rt ? (I + 1) * nt : rt;
    if (part-- == 0) return Part{a0, a1, a0, a1, true};
    const int hr = (a1 - a0 + sp - 1) / sp;
    for (int J = I + 1; J < nb; ++J)
      for (int h = 0; h < sp; ++h)
        if (part-- == 0)
          return Part{a0 + h * hr, a0 + (h + 1) * hr < a1 ? a0 + (h + 1) * hr : a1, J * nt,
                      (J + 1) * nt < rt ? (J + 1) * nt : rt, false};
  }
  return Part{0, 0, 0, 0, false};
}

// Items (tiles, plus stripes of b on the diagonal) of a part, and its
// tiles.
__host__ __device__ inline int part_items(const Part& p, int* tiles) {
  const int n = p.r1 - p.r0, m = p.c1 - p.c0;
  *tiles = p.diag ? n * (n + 1) / 2 : n * m;
  return *tiles + (p.diag ? n : 0);
}

// The columns a part's gathered rows hold: its rows' segment, and for an
// off-diagonal part its columns' segment after it.
__host__ __device__ inline int part_columns(const Part& p) {
  return 8 * (p.r1 - p.r0 + (p.diag ? 0 : p.c1 - p.c0));
}

// The tile-group route's block at rank R: one slot group (each part's
// sums run in slot order), as many threads as the largest part has
// items, and gathered rows as wide as the widest part's (at most 256
// columns), so its shared memory does not grow with the rank: two blocks
// share an SM.
inline AsmShape part_shape(int R) {
  AsmShape s;
  s.rt = (R + 7) / 8;
  int most = 0, widest = 0;
  for (int q = 0; q < band_parts(s.rt); ++q) {
    const Part p = part_of(s.rt, q);
    int tiles = 0;
    most = std::max(most, part_items(p, &tiles));
    widest = std::max(widest, part_columns(p));
  }
  s.rs = (skew(widest - 1) + 4) & ~3;
  s.tiles = s.items = most;
  s.groups = 1;
  s.workers = most;
  s.threads = (most + 31) / 32 * 32;
  s.smem_bytes = (2 * static_cast<size_t>(PART_CHUNK) * s.rs +
                  ASM_META * (3 * PART_CHUNK + ASM_GROUPS) + 4 + 3 * ASM_SLICE) *
                 sizeof(float);
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A bf16 factor of Y, held as its 16 bits (uint16_t), as fp32: they are
// the high half of the fp32 value.
__device__ __forceinline__ float load_factor(const uint16_t* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
}
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// dst[0..n) = (add[c] +) v[c] for the n <= 8 entries of a row segment
// inside the matrix; two 16-byte stores when `vec` and n == 8.
__device__ __forceinline__ void store_row8(float* dst, const float (&v)[8], int n,
                                           const float* add, bool vec) {
  if (vec && n == 8) {
    float4 a = make_float4(v[0], v[1], v[2], v[3]);
    float4 b = make_float4(v[4], v[5], v[6], v[7]);
    if (add != nullptr) {
      const float4 g0 = reinterpret_cast<const float4*>(add)[0];
      const float4 g1 = reinterpret_cast<const float4*>(add)[1];
      a = make_float4(g0.x + a.x, g0.y + a.y, g0.z + a.z, g0.w + a.w);
      b = make_float4(g1.x + b.x, g1.y + b.y, g1.z + b.z, g1.w + b.w);
    }
    reinterpret_cast<float4*>(dst)[0] = a;
    reinterpret_cast<float4*>(dst)[1] = b;
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (c < n) dst[c] = add != nullptr ? add[c] + v[c] : v[c];
}

// Sums slots of solve rows into S = sum aw * y y^T and s = sum bw * y and
// writes gram + S (its upper tiles, mirrored) to out_A and s to out_b;
// with gram null it writes S alone, a partial for assemble_reduce_kernel.
// Thread g * items + it sums item `it` (an 8 x 8 tile of A on or above
// the diagonal, or a stripe of 8 entries of b) in registers. Two modes:
// - split (grouped == 0): the block owns task = row * n_spans + span, the
//   slots [span * W, span * W + W) of one row; each 64-slot chunk is one
//   list of live slots that the groups stride through (g, g + groups,
//   ...), and their sums are added in group order at the end;
// - grouped (rows of at most W slots): group g owns row
//   blockIdx.x * groups + g alone; a chunk holds 64 / groups slots of
//   each of the block's rows, and no sums are exchanged.
// The block's slice of (cols, aw, bw) is staged in shared memory first.
// Warp 0 compacts each chunk's live slots (a weight not 0) from it, so
// padding is neither gathered nor summed, and the chunks ping-pong
// between two shared buffers: the next chunk's factor rows load by
// cp.async while this one is summed (a bf16 chunk through registers, see
// gather). Threads past items * groups (the block is a whole number of
// warps) only stage and gather. `vec` (R % 4 == 0, the pointers 16-byte
// aligned): A's rows take 16-byte stores and fp32 factor rows 16-byte
// copies; a bf16 row is copied 16 bytes (8 values) at a time when R % 8
// == 0 and Y is 16-byte aligned.
template <typename T, int MAX_THREADS, int MIN_BLOCKS, bool kParts>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
assemble_kernel(const T* __restrict__ Y, int M, int R, const int* __restrict__ cols,
                const float* __restrict__ aw, const float* __restrict__ bw, int B, int L,
                int W, int n_spans, int grouped, const float* __restrict__ gram,
                float* __restrict__ out_A, float* __restrict__ out_b, long long stride_A,
                long long stride_b, AsmShape shape, int vec, CfgStrides cfg) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  {  // this block's configuration: every pointer below is its own slice
    const long long z = blockIdx.y;
    Y += z * cfg.y;
    aw += z * cfg.w;
    bw += z * cfg.w;
    if (gram != nullptr) gram += z * cfg.gram;
    out_A += z * cfg.a;
    out_b += z * cfg.b;
  }
  constexpr int kWidth = 16 / sizeof(T);  // factors a 16-byte copy moves
  const bool gvec =
      kF32 ? vec != 0 : R % 8 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  extern __shared__ float smem[];
  const int rs = shape.rs, rt = shape.rt;
  const int groups = shape.groups;
  // kParts: block x is part x % n_parts of task x / n_parts (its tile
  // group); else the task is the block
  const int n_parts = kParts ? band_parts(rt) : 1;
  const long long bx = blockIdx.x / n_parts;
  const int part = static_cast<int>(blockIdx.x - bx * n_parts);
  // this block's items and tiles, and the gathered row: columns [c0, c0
  // + w0) at 0 and, for an off-diagonal part, [c1, c1 + w1) at w0
  int tiles = shape.tiles, items = shape.items;
  Part pt{0, rt, 0, rt, true};  // the whole matrix, unless kParts
  int c0 = 0, w0 = R, c1 = 0, w1 = 0;
  if constexpr (kParts) {
    pt = part_of(rt, part);
    items = part_items(pt, &tiles);
    c0 = 8 * pt.r0;
    w0 = min(8 * pt.r1, R) - c0;
    if (!pt.diag) {
      c1 = 8 * pt.c0;
      w1 = min(8 * pt.c1, R) - c1;
    }
  }
  // slots gathered at a time: the tile-group route's rows take half the
  // main route's chunk, so two of its blocks share an SM
  constexpr int kChunk = kParts ? PART_CHUNK : ASM_CHUNK;
  const int nsub = grouped ? groups : 1;  // lists of live slots per chunk
  const int sub = kChunk / nsub;       // slots of one list
  float* ys = smem;  // [2][kChunk][rs]; after the slots, [groups - 1][items][64]
  float* red = smem;
  int* scol = reinterpret_cast<int*>(smem + max(2 * kChunk * rs, (groups - 1) * items * 64));
  float* saw = reinterpret_cast<float*>(scol + ASM_META * kChunk);
  float* sbw = saw + ASM_META * kChunk;
  int* snlive = reinterpret_cast<int*>(sbw + ASM_META * kChunk);  // [ASM_META][nsub]

  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int g = tid / items, it = tid - g * items;
  const bool worker = tid < items * groups;
  const long long n_tasks = static_cast<long long>(B) * n_spans;
  const long long task = grouped ? bx * groups + g : bx;
  const int l_begin = grouped ? 0 : static_cast<int>(bx % n_spans) * W;
  const int lj = grouped ? L : min(W, L - l_begin);  // slots of one list
  int& s_last = snlive[ASM_META * ASM_GROUPS];  // the last live slot of any list
  if (tid == 0) s_last = -1;

  // the block's slice of (cols, aw, bw), [nsub][lj] each, staged once:
  // the chunks then read it from shared memory, so no chunk waits on a
  // device-memory load; rows past the batch stage as zeros (not live)
  int* mcol = snlive + ASM_META * ASM_GROUPS + 4;
  float* maw = reinterpret_cast<float*>(mcol + nsub * lj);
  float* mbw = maw + nsub * lj;
  for (int j = 0; j < nsub; ++j) {
    const long long t = grouped ? bx * groups + j : bx;
    const bool in = t < n_tasks;
    const long long base = in ? (t / n_spans) * L + l_begin : 0;
    for (int u = tid; u < lj; u += blockDim.x) {
      cp_async4(mcol + j * lj + u, cols + base + u, in ? 4 : 0);
      cp_async4(maw + j * lj + u, aw + base + u, in ? 4 : 0);
      cp_async4(mbw + j * lj + u, bw + base + u, in ? 4 : 0);
    }
  }
  cp_async_commit();

  // item `it`: an upper tile (ti, tj) of A, or a stripe ti of b; (ui,
  // uj) its place among this block's tiles (the whole matrix unless
  // kParts), whose segments a gathered row holds at si and sj
  const bool is_b = it >= tiles;
  const int nl = pt.r1 - pt.r0;  // tile rows of the block
  int ui = is_b ? it - tiles : 0, uj = 0;
  if (!is_b) {
    if (pt.diag) {
      int p = it;
      while (p >= nl - ui) {
        p -= nl - ui;
        ++ui;
      }
      uj = ui + p;
    } else {
      const int m = pt.c1 - pt.c0;
      ui = it / m;
      uj = it - ui * m;
    }
  }
  const int ti = pt.r0 + ui, tj = (pt.diag ? pt.r0 : pt.c0) + uj;
  const int i0 = ti * 8, j0 = tj * 8;
  const int si = skew(8 * ui);
  const int sj = skew((pt.diag ? 0 : 8 * nl) + 8 * uj);

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  // The last live slot of any list: the chunks after it are padding and
  // are not visited.
  cp_async_wait<0>();
  __syncthreads();
  {
    int last = -1;
    for (int j = 0; j < nsub; ++j)
      for (int u = tid; u < lj; u += blockDim.x)
        if (maw[j * lj + u] != 0.f || mbw[j * lj + u] != 0.f) last = max(last, u);
    if (last >= 0) atomicMax(&s_last, last);
  }
  __syncthreads();
  const int n_chunks = (s_last + sub) / sub;

  auto stage = [&](int c) {  // warp 0: each list's live slots of chunk c, in slot order
    if (tid >= 32) return;
    const int m = c % ASM_META, m0 = m * kChunk;
    int first_half = 0;  // the one list's live slots in positions 0..31
#pragma unroll
    for (int h = 0; h < kChunk / 32; ++h) {
      const int p = 32 * h + lane, j = p * nsub / kChunk, u = c * sub + p - j * sub;
      const int k = j * lj + u;
      const float a = u < lj ? maw[k] : 0.f, w = u < lj ? mbw[k] : 0.f;
      const bool live = a != 0.f || w != 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      const unsigned seg = sub >= 32 ? 0xffffffffu : 0xffffu << (lane & 16);
      const int before = h == 1 && sub == kChunk ? first_half : 0;
      if (live) {
        const int s = m0 + j * sub + before + __popc(ballot & seg & below);
        scol[s] = mcol[k];
        saw[s] = a;
        sbw[s] = w;
      }
      const int count = __popc(ballot & seg);
      if (sub == kChunk) {
        if (h + 1 < kChunk / 32)
          first_half = count;
        else if (lane == 0)
          snlive[m * nsub] = first_half + count;
      } else if (lane % sub == 0) {
        snlive[m * nsub + j] = count;
      }
    }
  };
  // each warp copies whole gathered rows, spw rows a pass, lane lq of a
  // row taking copies lq, lq + qstep, ... of 16 bytes (or one factor);
  // copy q < per0 is column c0 + unit * q, at unit * q, the rest band J's
  const int unit = gvec ? kWidth : 1;
  const int per0 = w0 / unit, per = per0 + w1 / unit;
  const int spw = per >= 32 ? 1 : 32 / per;
  const int lrow = per >= 32 ? 0 : lane / per, lq = lane - lrow * per;
  const int qstep = per >= 32 ? 32 : per, warp = tid >> 5, n_warps = blockDim.x >> 5;
  auto gather = [&](int c) {  // factor rows of chunk c's live slots
    const int m = c % ASM_META, m0 = m * kChunk;
    float* dst = ys + (c & 1) * kChunk * rs;
    if (lrow >= spw) return;
    for (int s = warp * spw + lrow; s < kChunk; s += n_warps * spw) {
      const int j = s * nsub / kChunk;
      if (s - j * sub >= snlive[m * nsub + j]) continue;  // past the list's live slots
      const int col = scol[m0 + s];
      const bool ok = col >= 0 && col < M;
      const T* src = ok ? Y + static_cast<long long>(col) * R : Y;
      for (int q = lq; q < per; q += qstep) {
        int sc = unit * q, dc = sc;  // source column, its place in the gathered row
        if constexpr (kParts) {
          if (q < per0) {
            sc += c0;
          } else {
            dc = w0 + unit * (q - per0);
            sc = c1 + unit * (q - per0);
          }
        }
        if constexpr (kF32) {
          if (gvec)
            cp_async16(dst + s * rs + skew(dc), src + sc, ok ? 16 : 0);
          else
            cp_async4(dst + s * rs + skew(dc), src + sc, ok ? 4 : 0);
        } else if (gvec) {  // 8 bf16 values -> 8 fp32 (one 32-column group: no skew inside)
          const uint4 u = ok ? __ldg(reinterpret_cast<const uint4*>(src + sc))
                             : make_uint4(0u, 0u, 0u, 0u);
          float4* d = reinterpret_cast<float4*>(dst + s * rs + skew(dc));
          d[0] = make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
          d[1] = make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w));
        } else {
          dst[s * rs + skew(dc)] = ok ? load_factor(src + sc) : 0.f;
        }
      }
    }
  };

  // One barrier a chunk: it publishes chunk c's factor rows and chunk
  // c + 1's live slots, and frees the buffer chunk c - 1 was summed from
  // for chunk c + 1's copies, which then overlap chunk c's sums.
  if (n_chunks > 0) {
    stage(0);
    __syncthreads();
    gather(0);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    if (c + 1 < n_chunks) stage(c + 1);
    __syncthreads();
    if (c + 1 < n_chunks) {
      gather(c + 1);
      cp_async_commit();
    }
    const int m = c % ASM_META;
    const float* yb = ys + (c & 1) * kChunk * rs;
    const int s0 = grouped ? g * sub : g, step = grouped ? 1 : groups;
    const int s_end = !worker ? s0 : grouped ? g * sub + snlive[m * nsub + g] : snlive[m * nsub];
    const float* wts = (is_b ? sbw : saw) + m * kChunk;
    if (!is_b) {
      for (int s = s0; s < s_end; s += step) {
        const float w = wts[s];
        const float* y = yb + s * rs;
        const float4 a0 = *reinterpret_cast<const float4*>(y + si);
        const float4 a1 = *reinterpret_cast<const float4*>(y + si + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(y + sj);
        const float4 b1 = *reinterpret_cast<const float4*>(y + sj + 4);
        const float yi[8] = {w * a0.x, w * a0.y, w * a0.z, w * a0.w,
                             w * a1.x, w * a1.y, w * a1.z, w * a1.w};
        const float yj[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) acc[a][cc] = fmaf(yi[a], yj[cc], acc[a][cc]);
      }
    } else {
      for (int s = s0; s < s_end; s += step) {
        const float w = wts[s];
        const float* y = yb + s * rs;
        const float4 a0 = *reinterpret_cast<const float4*>(y + si);
        const float4 a1 = *reinterpret_cast<const float4*>(y + si + 4);
        const float yi[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a) acc[0][a] = fmaf(w, yi[a], acc[0][a]);
      }
    }
  }
  cp_async_wait<0>();

  if (!grouped) {  // groups 1.. hand their sums to group 0, added in group order
    __syncthreads();
    if (g > 0 && worker) {
      float4* mine =
          reinterpret_cast<float4*>(red + (static_cast<size_t>(g - 1) * items + it) * 64);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        mine[2 * a] = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        mine[2 * a + 1] = make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
      }
    }
    __syncthreads();
    if (g > 0) return;
    for (int gg = 1; gg < groups; ++gg) {
      const float* o = red + (static_cast<size_t>(gg - 1) * items + it) * 64;
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] += o[a * 8 + c];
    }
  }
  if (!worker || task >= n_tasks) return;
  if (is_b) {
    float* ob = out_b + task * stride_b;
#pragma unroll
    for (int a = 0; a < 8; ++a)
      if (i0 + a < R) ob[i0 + a] = acc[0][a];
    return;
  }
  float* oA = out_A + task * stride_A;
  float v[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {  // rows i0.., on a diagonal tile from its upper half
    const int i = i0 + a;
    if (i >= R) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = ti == tj && c < a ? acc[c][a] : acc[a][c];
    store_row8(oA + i * R + j0, v, min(8, R - j0),
               gram != nullptr ? gram + i * R + j0 : nullptr, vec);
  }
  if (ti == tj) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // the mirror: rows j0.., columns i0..
    const int j = j0 + c;
    if (j >= R) continue;
#pragma unroll
    for (int a = 0; a < 8; ++a) v[a] = acc[a][c];
    store_row8(oA + j * R + i0, v, min(8, R - i0),
               gram != nullptr ? gram + j * R + i0 : nullptr, vec);
  }
}

// A[row] = gram + (P[row, 0] + P[row, 1] + ...), b[row] = Pb[row, 0] + ...:
// the spans' partials of assemble_kernel, added in span order. Block
// (row, z) reduces config z's row from its own slices: P + z * p_cfg,
// gram + z * cfg.gram, A + z * cfg.a and b + z * cfg.b.
__global__ void __launch_bounds__(REDUCE_THREADS)
assemble_reduce_kernel(const float* __restrict__ P, int n_spans, int R,
                       const float* __restrict__ gram, float* __restrict__ A,
                       float* __restrict__ b, long long p_cfg, CfgStrides cfg) {
  {
    const long long z = blockIdx.y;
    P += z * p_cfg;
    gram += z * cfg.gram;
    A += z * cfg.a;
    b += z * cfg.b;
  }
  const long long row = blockIdx.x;
  const long long stride = static_cast<long long>(R) * R + R;
  const float* pr = P + row * n_spans * stride;
  for (int e = threadIdx.x; e < R * R + R; e += blockDim.x) {
    float v = pr[e];
    for (int s = 1; s < n_spans; ++s) v += pr[s * stride + e];
    if (e < R * R)
      A[row * R * R + e] = gram[e] + v;
    else
      b[row * R + e - R * R] = v;
  }
}

// assemble_kernel for `shape` over `configs` configurations (blockIdx.y):
// built for three blocks an SM up to ASM_SMALL_THREADS threads a block
// (R <= 64), else for one; `parts` launches the tile-group route, each
// task's band_parts blocks in a row.
template <typename T, typename... Args>
void launch_assemble(unsigned blocks, unsigned configs, const AsmShape& shape, bool parts,
                     cudaStream_t s, const T* Y, Args... args) {
  const dim3 grid(blocks, configs);
  if (parts)
    assemble_kernel<T, PART_THREADS, 2, true>
        <<<grid, shape.threads, shape.smem_bytes, s>>>(Y, args...);
  else if (shape.threads <= ASM_SMALL_THREADS)
    assemble_kernel<T, ASM_SMALL_THREADS, 3, false>
        <<<grid, shape.threads, shape.smem_bytes, s>>>(Y, args...);
  else
    assemble_kernel<T, ASM_MAX_THREADS, 1, false>
        <<<grid, shape.threads, shape.smem_bytes, s>>>(Y, args...);
}

// Floats of one system's workspace in spd_solve_warp_kernel: the packed
// upper triangle of U (T(R) = R(R+1)/2) and then v.
__host__ __device__ inline long long solve_ws_floats(int R) {
  return static_cast<long long>(R) * (R + 1) / 2 + R;
}

// One window of row i of U, for the NM column groups j = cb + lane + 32m
// (m < NM) of the window that reach into the matrix: s = a_ij, then
// s = s - u_ki * u_kj for k = 0..i-1 in order (each product and
// subtraction rounded), then u_ij = s * inv_i, written over a_ij. The
// window at the diagonal (first) takes inv_i from its pivot, s[0] of lane
// i & 31. u_ki is one address (a broadcast), u_kj consecutive words; both
// walk down the rows k by the packed layout's shrinking step. Lanes left
// of the diagonal compute values that are never stored; their reads stay
// inside rows k < i.
template <int NM>
__device__ __forceinline__ void solve_row_window(float* U, int R, int i, int offi, int cb,
                                                 int lane, bool first, float& inv) {
  float* Ui = U + offi - i;  // Ui[j] = a_ij, then u_ij
  float s[NM];
  bool in[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int j = cb + 32 * m + lane;
    in[m] = j < R;
    s[m] = in[m] ? Ui[j] : 0.f;
  }
  const float* pi = U + i;          // u_ki for k = 0
  const float* pj = U + cb + lane;  // u_kj of the lane's first group, k = 0
  int step = R - 1;                 // from row k to row k + 1: off(k+1) - (k+1) - (off(k) - k)
#pragma unroll 4
  for (int k = 0; k < i; ++k) {
    const float uki = *pi;
#pragma unroll
    for (int m = 0; m < NM; ++m)
      if (in[m]) s[m] = __fsub_rn(s[m], __fmul_rn(uki, pj[32 * m]));
    pi += step;
    pj += step;
    --step;
  }
  if (first) {
    const float d = __shfl_sync(0xffffffffu, s[0], i & 31);
    inv = 1.f / sqrtf(fmaxf(d, 1e-30f));
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int j = cb + 32 * m + lane;
    if (j >= i && in[m]) Ui[j] = __fmul_rn(s[m], inv);
  }
}

// Rows i and i + 1 of U together (i even, so both start their windows at
// the same 32-column group): the k loop loads each u_kj once for both
// rows, then row i is finished, and row i + 1 takes its step k = i from
// row i's values in registers (u_{i,i+1} by a shuffle) before its own
// pivot. Every entry takes the same operations in the same order as in
// solve_row_window.
template <int NM>
__device__ __forceinline__ void solve_row_pair_window(float* U, int R, int i, int offi, int cb,
                                                      int lane, bool first, float& inv0,
                                                      float& inv1, float& u01) {
  float* U0 = U + offi - i;                // U0[j] = a_ij, then u_ij
  float* U1 = U + offi + (R - i) - i - 1;  // U1[j] = a_{i+1,j}, then u_{i+1,j}
  float s0[NM], s1[NM];
  bool in[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int j = cb + 32 * m + lane;
    in[m] = j < R;
    s0[m] = in[m] ? U0[j] : 0.f;
    s1[m] = in[m] ? U1[j] : 0.f;
  }
  const float* pi = U + i;          // u_ki and u_{k,i+1} for k = 0
  const float* pj = U + cb + lane;  // u_kj of the lane's first group, k = 0
  int step = R - 1;
#pragma unroll 4
  for (int k = 0; k < i; ++k) {
    const float uki = pi[0], uki1 = pi[1];
#pragma unroll
    for (int m = 0; m < NM; ++m)
      if (in[m]) {
        const float ukj = pj[32 * m];
        s0[m] = __fsub_rn(s0[m], __fmul_rn(uki, ukj));
        s1[m] = __fsub_rn(s1[m], __fmul_rn(uki1, ukj));
      }
    pi += step;
    pj += step;
    --step;
  }
  if (first) {
    const float d = __shfl_sync(0xffffffffu, s0[0], i & 31);
    inv0 = 1.f / sqrtf(fmaxf(d, 1e-30f));
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int j = cb + 32 * m + lane;
    s0[m] = __fmul_rn(s0[m], inv0);  // u_ij
    if (j >= i && in[m]) U0[j] = s0[m];
  }
  if (first) u01 = __shfl_sync(0xffffffffu, s0[0], (i + 1) & 31);
#pragma unroll
  for (int m = 0; m < NM; ++m)
    if (in[m]) s1[m] = __fsub_rn(s1[m], __fmul_rn(u01, s0[m]));
  if (first) {
    const float d = __shfl_sync(0xffffffffu, s1[0], (i + 1) & 31);
    inv1 = 1.f / sqrtf(fmaxf(d, 1e-30f));
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int j = cb + 32 * m + lane;
    if (j > i && in[m]) U1[j] = __fmul_rn(s1[m], inv1);
  }
}

__device__ __forceinline__ int packed_off(int i, int R) { return i * R - i * (i - 1) / 2; }

// U^T y = b, then U x = y, for R <= SOLVE_CHUNK: v[j] lives in register
// vr[j >> 5] of lane j & 31. At step k every lane takes v[k] by a shuffle
// and divides it by u_kk itself (the same operands, so the same y_k), and
// the lanes holding v[j], j > k (j < k going back), subtract u_kj * y_k:
// the plain version's column sweeps, operation for operation.
__device__ __forceinline__ void solve_sweeps_registers(const float* U, const float* bs, float* xs,
                                                       int R, int lane) {
  float vr[SOLVE_MC];
#pragma unroll
  for (int t = 0; t < SOLVE_MC; ++t) {
    const int j = 32 * t + lane;
    vr[t] = j < R ? bs[j] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < SOLVE_MC; ++t) {
    if (32 * t < R) {
      const int kend = min(32, R - 32 * t);
      for (int kk = 0; kk < kend; ++kk) {
        const int k = 32 * t + kk;
        const float* Uk = U + packed_off(k, R) - k;
        const float yk = __shfl_sync(0xffffffffu, vr[t], kk) / Uk[k];
#pragma unroll
        for (int t2 = t; t2 < SOLVE_MC; ++t2) {
          if (32 * t2 >= R) break;  // warp-uniform: past the matrix
          const int j = 32 * t2 + lane;
          if (j == k)
            vr[t2] = yk;
          else if (j > k && j < R)
            vr[t2] = __fsub_rn(vr[t2], __fmul_rn(Uk[j], yk));
        }
      }
    }
  }
  int col[SOLVE_MC];  // off(i) - i for i = 32t + lane: u_ik at col[t] + k
#pragma unroll
  for (int t = 0; t < SOLVE_MC; ++t) {
    const int i = min(32 * t + lane, R - 1);
    col[t] = packed_off(i, R) - i;
  }
#pragma unroll
  for (int t = SOLVE_MC - 1; t >= 0; --t) {
    if (32 * t < R) {
      for (int kk = min(31, R - 1 - 32 * t); kk >= 0; --kk) {
        const int k = 32 * t + kk;
        const float xk = __shfl_sync(0xffffffffu, vr[t], kk) / U[packed_off(k, R)];
#pragma unroll
        for (int t2 = 0; t2 <= t; ++t2) {
          const int i = 32 * t2 + lane;
          if (i == k)
            vr[t2] = xk;
          else if (i < k)
            vr[t2] = __fsub_rn(vr[t2], __fmul_rn(U[col[t2] + k], xk));
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < SOLVE_MC; ++t) {
    const int j = 32 * t + lane;
    if (j < R) xs[j] = vr[t];
  }
}

// spd_solve_warp_kernel: one warp solves one system, its workspace in
// shared memory (warp w of the block at w * ws); block b's warp w takes
// system b * warps + w.
__global__ void __launch_bounds__(SOLVE_MAX_WARPS * 32)
spd_solve_warp_kernel(const float* __restrict__ A, const float* __restrict__ b,
                      float* __restrict__ x, int B, int R) {
  static_assert(SOLVE_MC == 8, "solve_row_window is dispatched for 1..8 column groups");
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ws = solve_ws_floats(R);
  const long long sys = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (sys >= B) return;
  float* U = smem + warp * ws;  // row i at off(i)
  const float* As = A + sys * R * R;
  // A's upper triangle into the workspace, packed as U will be, every
  // load in flight at once (cp.async): the rows then wait on no
  // device-memory load, and U overwrites A in place.
  for (int i = 0, offi = 0; i < R; offi += R - i, ++i)
    for (int j = i + lane; j < R; j += 32)
      cp_async4(U + offi + j - i, As + static_cast<long long>(i) * R + j, 4);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  // Up-looking Cholesky: row i of U from A's row i and rows k < i of U.
  // Entry (i, j) takes a = a - u_ki * u_kj for k = 0..i-1 in order, each
  // product and subtraction rounded, then u_ij = a * inv_i: the plain
  // version's sequence for that entry, so the result is bitwise equal.
  // The row's columns from the 32-column group holding the diagonal are
  // covered in windows of SOLVE_CHUNK; the pivot is s[0] of lane i & 31.
  // Rows i, i + 1 (i even) go together; an odd rank's last row alone.
  for (int i = 0, offi = 0; i < R;) {
    const int w0 = i & ~31;  // i is even: rows i and i + 1 share it
    float inv0 = 0.f, inv1 = 0.f, u01 = 0.f;
    if (i + 1 < R) {
      for (int cb = w0; cb < R; cb += SOLVE_CHUNK) {
        const bool first = cb == w0;
        switch (min(SOLVE_MC, (R - cb + 31) >> 5)) {  // column groups inside the matrix
          case 1: solve_row_pair_window<1>(U, R, i, offi, cb, lane, first, inv0, inv1, u01); break;
          case 2: solve_row_pair_window<2>(U, R, i, offi, cb, lane, first, inv0, inv1, u01); break;
          case 3: solve_row_pair_window<3>(U, R, i, offi, cb, lane, first, inv0, inv1, u01); break;
          case 4: solve_row_pair_window<4>(U, R, i, offi, cb, lane, first, inv0, inv1, u01); break;
          case 5: solve_row_pair_window<5>(U, R, i, offi, cb, lane, first, inv0, inv1, u01); break;
          case 6: solve_row_pair_window<6>(U, R, i, offi, cb, lane, first, inv0, inv1, u01); break;
          case 7: solve_row_pair_window<7>(U, R, i, offi, cb, lane, first, inv0, inv1, u01); break;
          default: solve_row_pair_window<8>(U, R, i, offi, cb, lane, first, inv0, inv1, u01); break;
        }
      }
      offi += 2 * (R - i) - 1;
      i += 2;
    } else {  // the last row of an odd rank
      for (int cb = w0; cb < R; cb += SOLVE_CHUNK) {
        const bool first = cb == w0;
        switch (min(SOLVE_MC, (R - cb + 31) >> 5)) {
          case 1: solve_row_window<1>(U, R, i, offi, cb, lane, first, inv0); break;
          case 2: solve_row_window<2>(U, R, i, offi, cb, lane, first, inv0); break;
          case 3: solve_row_window<3>(U, R, i, offi, cb, lane, first, inv0); break;
          case 4: solve_row_window<4>(U, R, i, offi, cb, lane, first, inv0); break;
          case 5: solve_row_window<5>(U, R, i, offi, cb, lane, first, inv0); break;
          case 6: solve_row_window<6>(U, R, i, offi, cb, lane, first, inv0); break;
          case 7: solve_row_window<7>(U, R, i, offi, cb, lane, first, inv0); break;
          default: solve_row_window<8>(U, R, i, offi, cb, lane, first, inv0); break;
        }
      }
      ++i;
    }
    __syncwarp();
  }
  solve_sweeps_registers(U, b + sys * R, x + sys * R, R, lane);
}

// Rows r and r + 1 of U over one window of the NM column groups j = cb
// + lane + 32m inside the matrix, the steps k < k1 only (rows finished
// earlier): s = a_rj - u_0r u_0j - ... - u_{k1-1,r} u_{k1-1,j}, each
// product rounded before its subtraction, written back over a_rj (j >=
// r; row r + 1 at j > r) for the rest of the row's sequence. Each u_kj is
// loaded once for both rows. r + 1 may lie past the matrix (an odd
// rank's last row): then only row r is kept.
template <int NM>
__device__ __forceinline__ void solve_pair_bulk(float* U, int R, int r, int k1, int cb,
                                                int lane) {
  float* U0 = U + packed_off(r, R) - r;  // U0[j] = a_rj
  float* U1 = U0 + (R - r) - 1;          // U1[j] = a_{r+1,j}
  const bool two = r + 1 < R;
  float s0[NM], s1[NM];
  bool in[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int j = cb + 32 * m + lane;
    in[m] = j < R;
    s0[m] = in[m] ? U0[j] : 0.f;
    s1[m] = in[m] && two ? U1[j] : 0.f;
  }
  const float* pi = U + r;          // u_kr and u_{k,r+1} for k = 0
  const float* pj = U + cb + lane;  // u_kj of the lane's first group, k = 0
  int step = R - 1;
#pragma unroll 4
  for (int k = 0; k < k1; ++k) {
    const float ukr = pi[0], ukr1 = pi[1];
#pragma unroll
    for (int m = 0; m < NM; ++m)
      if (in[m]) {
        const float ukj = pj[32 * m];
        s0[m] = __fsub_rn(s0[m], __fmul_rn(ukr, ukj));
        s1[m] = __fsub_rn(s1[m], __fmul_rn(ukr1, ukj));
      }
    pi += step;
    pj += step;
    --step;
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int j = cb + 32 * m + lane;
    if (in[m] && j >= r) U0[j] = s0[m];
    if (in[m] && two && j > r) U1[j] = s1[m];
  }
}

// U^T y = b, then U x = y, for spd_solve_block_kernel: v in the
// workspace, its 32-entry chunk c owned by warp c % SOLVE_BLOCK_WARPS.
// Each sweep goes a chunk at a time: the chunk's owner takes its 32 steps
// one by one (lane l holds v of the chunk's entry l; y_k (x_k) crosses
// lanes by a shuffle), a barrier publishes them, and every warp applies
// the chunk's 32 steps, in order, to the chunks it owns further along.
// So each v_j takes the plain version's subtractions in its order, each
// product rounded first, at 2 ceil(R / 32) barriers a system. The block's
// last barrier frees the workspace for its next system.
__device__ __forceinline__ void solve_sweeps_block(const float* U, float* v, const float* bs,
                                                   float* xs, int R, int warp, int lane) {
  const int nch = (R + 31) >> 5;
  for (int c = warp; c < nch; c += SOLVE_BLOCK_WARPS)
    if (32 * c + lane < R) v[32 * c + lane] = bs[32 * c + lane];
  __syncwarp();
  for (int p = 0; p < nch; ++p) {  // U^T y = b: steps k of chunk p, ascending
    const int j = 32 * p + lane, kn = min(32, R - 32 * p);
    if (warp == p % SOLVE_BLOCK_WARPS) {
      // lane l: v_j and the diagonal u_jj of the chunk's entry j = 32p + l;
      // each step's u_kj is loaded off the chain of divisions
      float vj = j < R ? v[j] : 0.f;
      const float djj = j < R ? U[packed_off(j, R)] : 1.f;
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        if (kk < kn) {
          const int k = 32 * p + kk;
          const float ukj = lane > kk && j < R ? U[packed_off(k, R) - k + j] : 0.f;
          const float yk = __shfl_sync(0xffffffffu, vj, kk) / __shfl_sync(0xffffffffu, djj, kk);
          const float next = __fsub_rn(vj, __fmul_rn(ukj, yk));
          vj = lane == kk ? yk : lane > kk ? next : vj;
        }
      }
      if (j < R) v[j] = vj;
    }
    __syncthreads();
    for (int c = p + 1 + (warp - (p + 1) % SOLVE_BLOCK_WARPS + SOLVE_BLOCK_WARPS) %
                             SOLVE_BLOCK_WARPS;
         c < nch; c += SOLVE_BLOCK_WARPS) {
      const int jc = 32 * c + lane;
      if (jc >= R) continue;
      float vj = v[jc];
      for (int kk = 0; kk < kn; ++kk) {
        const int k = 32 * p + kk;
        vj = __fsub_rn(vj, __fmul_rn(U[packed_off(k, R) - k + jc], v[k]));
      }
      v[jc] = vj;
    }
  }
  for (int p = nch - 1; p >= 0; --p) {  // U x = y: steps k of chunk p, descending
    const int i = 32 * p + lane, top = min(31, R - 1 - 32 * p);
    if (warp == p % SOLVE_BLOCK_WARPS) {
      float vi = i < R ? v[i] : 0.f;
      const float dii = i < R ? U[packed_off(i, R)] : 1.f;
      const int offi = i < R ? packed_off(i, R) - i : 0;  // u_ik at offi + k
#pragma unroll
      for (int kk = 31; kk >= 0; --kk) {
        if (kk <= top) {
          const int k = 32 * p + kk;
          const float uik = lane < kk ? U[offi + k] : 0.f;
          const float xk = __shfl_sync(0xffffffffu, vi, kk) / __shfl_sync(0xffffffffu, dii, kk);
          const float next = __fsub_rn(vi, __fmul_rn(uik, xk));
          vi = lane == kk ? xk : lane < kk ? next : vi;
        }
      }
      if (i < R) v[i] = vi;
    }
    __syncthreads();
    for (int c = warp; c < p; c += SOLVE_BLOCK_WARPS) {
      const int ic = 32 * c + lane;  // c < p: inside the matrix
      const int offi = packed_off(ic, R) - ic;
      float vi = v[ic];
      for (int kk = top; kk >= 0; --kk) {
        const int k = 32 * p + kk;
        vi = __fsub_rn(vi, __fmul_rn(U[offi + k], v[k]));
      }
      v[ic] = vi;
    }
  }
  __syncthreads();
  for (int c = warp; c < nch; c += SOLVE_BLOCK_WARPS)
    if (32 * c + lane < R) xs[32 * c + lane] = v[32 * c + lane];
  __syncthreads();  // the workspace is free for the block's next system
}

// spd_solve_block_kernel: one block of SOLVE_BLOCK_WARPS warps solves one
// system, the ranks where one warp's workspace leaves no room for two in
// a block. The arithmetic of every entry is spd_solve_warp_kernel's (and
// the plain version's): a_ij - u_0i u_0j - u_1i u_1j - ... in k order,
// each product rounded before its subtraction, then times inv_i, so the
// result is bitwise equal to it; only the division of the work differs.
// Rows go 32 at a time, the rows [w0, w0 + 32) of one 32-column group:
// - bulk: warp q takes the group's row pair w0 + 2q, w0 + 2q + 1 and all
//   its columns from w0, in windows of up to 8 groups, over the steps k
//   < w0 (rows of earlier groups): the R^3 / 6 products and subtractions
//   but the group's own, each u_kj loaded once for both rows, 16 warps at
//   once, and the partial sums written back over A (barrier);
// - tail: the group's pairs in order. Each warp takes, in its column
//   groups, the pair's steps k = w0 .. r - 1 (the group's rows finished
//   before it); warp 0, whose columns w0 .. w0 + 31 hold every diagonal
//   of the group, then takes the pivots and u_{r,r+1}, finishes the pair
//   there and hands the pivots to the others (barrier; the scalars
//   alternate between two slots), which finish the pair in their groups
//   while warp 0 goes on to the next pair. A group costs one barrier a
//   pair and two more.
// Then the block runs the two sweeps (solve_sweeps_block).
// kShared: the workspace (the packed triangle, v, the pivot scalars) in
// shared memory, one block per system; else in device memory, one slot
// per block of the grid, each block looping over systems.
template <bool kShared>
__global__ void __launch_bounds__(SOLVE_BLOCK_WARPS * 32, 1)
spd_solve_block_kernel(const float* __restrict__ A, const float* __restrict__ b,
                       float* __restrict__ x, int B, int R, float* ws_dev) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ws = solve_ws_floats(R);
  float* U = kShared ? smem : ws_dev + static_cast<long long>(blockIdx.x) * (ws + SOLVE_SCALARS);
  float* scal = U + ws;  // [2][4]: inv_r, u_{r,r+1}, inv_{r+1}, by the pair's parity
  for (long long sys = blockIdx.x; sys < B; sys += gridDim.x) {
    const float* As = A + sys * R * R;
    for (int i = warp; i < R; i += SOLVE_BLOCK_WARPS) {
      const int offi = packed_off(i, R);
      for (int j = i + lane; j < R; j += 32) {
        if (kShared)
          cp_async4(U + offi + j - i, As + static_cast<long long>(i) * R + j, 4);
        else
          U[offi + j - i] = __ldg(As + static_cast<long long>(i) * R + j);
      }
    }
    if (kShared) {
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int w0 = 0; w0 < R; w0 += 32) {
      const int wend = min(w0 + 32, R), G = (R - w0 + 31) >> 5;
      if (w0 > 0) {  // the bulk: warp q, rows w0 + 2q and w0 + 2q + 1
        const int r = w0 + 2 * warp;
        if (r < wend)
          for (int cb = w0; cb < R; cb += SOLVE_CHUNK)
            switch (min(SOLVE_MC, (R - cb + 31) >> 5)) {
              case 1: solve_pair_bulk<1>(U, R, r, w0, cb, lane); break;
              case 2: solve_pair_bulk<2>(U, R, r, w0, cb, lane); break;
              case 3: solve_pair_bulk<3>(U, R, r, w0, cb, lane); break;
              case 4: solve_pair_bulk<4>(U, R, r, w0, cb, lane); break;
              case 5: solve_pair_bulk<5>(U, R, r, w0, cb, lane); break;
              case 6: solve_pair_bulk<6>(U, R, r, w0, cb, lane); break;
              case 7: solve_pair_bulk<7>(U, R, r, w0, cb, lane); break;
              default: solve_pair_bulk<8>(U, R, r, w0, cb, lane); break;
            }
        __syncthreads();
      }
      for (int p = w0; p < wend; p += 2) {  // the tail: rows p and p + 1
        float* sc = scal + ((p >> 1) & 1) * 4;
        float* Up = U + packed_off(p, R) - p;  // Up[j] = a_pj, then u_pj
        float* Uq = Up + (R - p) - 1;          // row p + 1
        const bool two = p + 1 < R;
        const float* Uw = U + packed_off(w0, R) - w0;  // row w0
        // every warp: its column groups g = warp, warp + 16, ... of rows p
        // and p + 1, the steps k = w0 .. p - 1 (the group's finished rows)
        for (int g = warp; g < G; g += SOLVE_BLOCK_WARPS) {
          const int j = w0 + 32 * g + lane;
          const bool in = j < R;
          float s0 = in ? Up[j] : 0.f, s1 = in && two ? Uq[j] : 0.f;
          const float* pi = Uw + p;  // u_kp and u_{k,p+1} for k = w0
          const float* pj = Uw + j;  // u_kj for k = w0
          int step = R - w0 - 1;
#pragma unroll 4
          for (int k = w0; k < p; ++k) {
            const float ukj = in ? *pj : 0.f;
            s0 = __fsub_rn(s0, __fmul_rn(pi[0], ukj));
            s1 = __fsub_rn(s1, __fmul_rn(pi[1], ukj));
            pi += step;
            pj += step;
            --step;
          }
          if (g == 0) {  // the pair's pivots, from the diagonal's lanes
            const float inv0 =
                1.f / sqrtf(fmaxf(__shfl_sync(0xffffffffu, s0, p & 31), 1e-30f));
            const float u0 = __fmul_rn(s0, inv0);
            const float u01 = __shfl_sync(0xffffffffu, u0, (p + 1) & 31);
            const float t1 = __fsub_rn(s1, __fmul_rn(u01, u0));
            const float inv1 =
                1.f / sqrtf(fmaxf(__shfl_sync(0xffffffffu, t1, (p + 1) & 31), 1e-30f));
            if (in && j >= p) Up[j] = u0;
            if (in && two && j > p) Uq[j] = __fmul_rn(t1, inv1);
            if (lane == 0) {
              sc[0] = inv0;
              sc[1] = u01;
              sc[2] = inv1;
            }
          } else if (in) {  // kept until the pivots arrive
            Up[j] = s0;
            if (two) Uq[j] = s1;
          }
        }
        __syncthreads();
        for (int g = warp > 0 ? warp : SOLVE_BLOCK_WARPS; g < G; g += SOLVE_BLOCK_WARPS) {
          const int j = w0 + 32 * g + lane;
          if (j < R) {
            const float u0 = __fmul_rn(Up[j], sc[0]);
            Up[j] = u0;
            if (two) Uq[j] = __fmul_rn(__fsub_rn(Uq[j], __fmul_rn(sc[1], u0)), sc[2]);
          }
        }
      }
      __syncthreads();  // the group's rows are finished
    }
    solve_sweeps_block(U, U + ws - R, b + sys * R, x + sys * R, R, warp, lane);
  }
}

}  // namespace

// Records `ev`, a CUDA event or null for none, on `s`: the entry points'
// ev_start / ev_end, recorded just before their first kernel and just
// after their last, so the caller times the kernels alone.
static cudaError_t record_event(void* ev, cudaStream_t s) {
  return ev == nullptr ? cudaSuccess : cudaEventRecord(static_cast<cudaEvent_t>(ev), s);
}

// An entry point's return: cudaGetLastError() after its launches, then
// ev_end recorded.
static int launched(void* ev_end, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = record_event(ev_end, s);
  return static_cast<int>(err);
}

extern "C" {

const char* pio_als_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest rank assemble_kernel takes on `device`: one thread for each
// upper tile and stripe of b fits a block, and its shared memory (two
// chunks of factor rows, or the groups' sums) what a block may opt into.
// Negative: a CUDA error.
int pio_assemble_max_rank(int device) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int r = 0;
  for (;;) {
    const AsmShape s = asm_shape(r + 1);
    if (s.groups < 1 || s.smem_bytes > static_cast<size_t>(optin))
      return r;
    ++r;
  }
}

// The shared memory one block may opt into on `device`: the host's
// spd_solve_plan picks the solve's route from it. Negative: a CUDA error.
int pio_als_smem_optin(int device) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err != cudaSuccess ? -static_cast<int>(err) : optin;
}

// Once per device, before its first pio_spd_solve or
// pio_assemble_normal_equations: lets assemble_kernel and the shared
// route of spd_solve_warp_kernel take all the shared memory a block may
// opt into (above the 48 KB default), and asks for the largest
// shared-memory carve-out so several blocks share an SM.
int pio_als_solve_init(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernels[] = {
      reinterpret_cast<const void*>(assemble_kernel<float, ASM_SMALL_THREADS, 3, false>),
      reinterpret_cast<const void*>(assemble_kernel<float, ASM_MAX_THREADS, 1, false>),
      reinterpret_cast<const void*>(assemble_kernel<uint16_t, ASM_SMALL_THREADS, 3, false>),
      reinterpret_cast<const void*>(assemble_kernel<uint16_t, ASM_MAX_THREADS, 1, false>),
      reinterpret_cast<const void*>(assemble_kernel<float, PART_THREADS, 2, true>),
      reinterpret_cast<const void*>(assemble_kernel<uint16_t, PART_THREADS, 2, true>),
      reinterpret_cast<const void*>(spd_solve_warp_kernel),
      reinterpret_cast<const void*>(spd_solve_block_kernel<true>)};
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"

namespace {

// pio_assemble_normal_equations(_grid) for a factor store of type T and
// K configurations (K = 1: one config, gridDim.y = 1); `parts`: the
// tile-group route.
template <typename T>
int assemble_entry(int device, const T* Y, int K, int M, int R, const int* cols, const float* aw,
                   const float* bw, int B, int L, int span, int n_spans, int grouped, int parts,
                   const float* gram, float* A, float* b, float* partial, void* stream,
                   void* ev_start, void* ev_end) {
  if (K <= 0 || K > 65535 || B <= 0 || R <= 0 || L < 0 || M <= 0 || span <= 0 ||
      span % ASM_CHUNK != 0 || n_spans < 1 || static_cast<long long>(n_spans) * span < L ||
      (n_spans > 1 && (static_cast<long long>(n_spans - 1) * span >= L || partial == nullptr ||
                       grouped)))
    return static_cast<int>(cudaErrorInvalidValue);
  const AsmShape shape = parts ? part_shape(R) : asm_shape(R);
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shape.groups < 1 || shape.smem_bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  // a block's slice of the tables must fit its staging area
  if ((grouped ? static_cast<long long>(shape.groups) * L : std::min(span, L)) > ASM_SLICE)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = record_event(ev_start, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rr = static_cast<long long>(R) * R;
  const long long per_partial = static_cast<long long>(B) * n_spans * (rr + R);
  // each config's slices: Y [M, R], aw / bw [B, L], gram [R, R], A [B, R,
  // R], b [B, R], the partials [B, n_spans, R * R + R]
  const CfgStrides cfg{static_cast<long long>(M) * R, static_cast<long long>(B) * L, rr,
                       static_cast<long long>(B) * rr, static_cast<long long>(B) * R};
  // the 16-byte paths test base pointers, so every config's slice must
  // keep their alignment, or the whole launch takes the scalar path
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const bool slices_aligned =
      K == 1 || ((cfg.y * static_cast<long long>(sizeof(T))) % 16 == 0 && cfg.gram % 4 == 0 &&
                 cfg.a % 4 == 0 && per_partial % 4 == 0);
  const int vec = R % 4 == 0 && aligned(Y) && aligned(gram) && aligned(A) &&
                  (partial == nullptr || aligned(partial)) && slices_aligned;
  const long long n_parts = parts ? band_parts(shape.rt) : 1;
  if (n_spans == 1) {
    const long long blocks = grouped ? (B + shape.groups - 1) / shape.groups : B;
    launch_assemble(static_cast<unsigned>(blocks * n_parts), static_cast<unsigned>(K), shape,
                    parts != 0, s, Y, M, R, cols, aw, bw, B, L, span, 1, grouped ? 1 : 0, gram, A,
                    b, rr, static_cast<long long>(R), shape, vec, cfg);
    return launched(ev_end, s);
  }
  const CfgStrides split{cfg.y, cfg.w, 0, per_partial, per_partial};
  launch_assemble(static_cast<unsigned>(static_cast<long long>(B) * n_spans * n_parts),
                  static_cast<unsigned>(K), shape, parts != 0, s, Y, M, R, cols, aw, bw, B, L,
                  span, n_spans, 0, static_cast<const float*>(nullptr), partial, partial + rr,
                  rr + R, rr + R, shape, vec, split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  assemble_reduce_kernel<<<dim3(static_cast<unsigned>(B), static_cast<unsigned>(K)),
                           REDUCE_THREADS, 0, s>>>(partial, n_spans, R, gram, A, b, per_partial,
                                                   cfg);
  return launched(ev_end, s);
}

}  // namespace

extern "C" {

// The config grid's assembly: K configurations of one solve side in one
// launch (the config in blockIdx.y), each exactly the single-config
// launch on its own slices: Y [K, M, R], aw / bw [K, B, L], gram [K, R,
// R] in, A [K, B, R, R] and b [K, B, R] out, the partials (split rows)
// [K, B, n_spans, R * R + R]; cols [B, L] is shared. Every config's sums
// come out in the order of its own single-config launch, and no scratch
// is shared between configs. K = 1 is pio_assemble_normal_equations.
int pio_assemble_normal_equations_grid(int device, const void* Y, int y_dtype, int K, int M,
                                       int R, const int* cols, const float* aw, const float* bw,
                                       int B, int L, int span, int n_spans, int grouped,
                                       int parts, const float* gram, float* A, float* b,
                                       float* partial, void* stream, void* ev_start,
                                       void* ev_end) {
  if (y_dtype == 0)
    return assemble_entry(device, static_cast<const float*>(Y), K, M, R, cols, aw, bw, B, L,
                          span, n_spans, grouped, parts, gram, A, b, partial, stream, ev_start,
                          ev_end);
  if (y_dtype == 1)
    return assemble_entry(device, static_cast<const uint16_t*>(Y), K, M, R, cols, aw, bw, B, L,
                          span, n_spans, grouped, parts, gram, A, b, partial, stream, ev_start,
                          ev_end);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A [B, R, R] and b [B, R] from Y [M, R], cols / aw / bw [B, L] and gram
// [R, R]; Y fp32 (y_dtype 0) or bf16 (y_dtype 1), the rest fp32 except
// cols (int32), contiguous, on `device`, which pio_als_solve_init has set
// up. The host's plan (assembly_plan in ops/als_cuda.py) gives `span` (a
// multiple of 64), the most slots one block sums for a row, and
// `n_spans`: with more than one, each row is n_spans blocks of `span`
// slots (the last holds the rest), each writing a partial to `partial`
// ([B, n_spans, R * R + R] fp32), which assemble_reduce_kernel adds to
// gram in span order. With `grouped` (one span) a block sums several rows,
// one per slot group. `parts` 0: R at most pio_assemble_max_rank(device),
// for either factor type; 1: the tile-group route, any rank, each task
// one block per pair of bands of A's columns. Launches on `stream`;
// returns cudaGetLastError(). ev_start / ev_end, when not null, are CUDA
// events recorded on `stream` around the kernels (no synchronisation
// here).
int pio_assemble_normal_equations(int device, const void* Y, int y_dtype, int M, int R,
                                  const int* cols, const float* aw, const float* bw, int B, int L,
                                  int span, int n_spans, int grouped, int parts, const float* gram,
                                  float* A, float* b, float* partial, void* stream,
                                  void* ev_start, void* ev_end) {
  return pio_assemble_normal_equations_grid(device, Y, y_dtype, 1, M, R, cols, aw, bw, B, L,
                                            span, n_spans, grouped, parts, gram, A, b, partial,
                                            stream, ev_start, ev_end);
}

// x [B, R] solving A x = b for A [B, R, R] (symmetric positive definite;
// the upper triangle is read) and b [B, R], fp32, contiguous, on
// `device`, which pio_als_solve_init has set up. The host's plan
// (spd_solve_plan in ops/als_cuda.py) gives the route: 0, one warp a
// system (spd_solve_warp_kernel), `warps` workspaces in a block's shared
// memory; 1, one block a system (spd_solve_block_kernel), its workspace
// in shared memory; 2, the same with `slots` workspaces of
// solve_ws_floats(R) + SOLVE_SCALARS floats in device memory
// (`workspace`), one per block of a grid of `slots` blocks. Launches on
// `stream`; returns cudaGetLastError(). ev_start / ev_end as in
// pio_assemble_normal_equations.
int pio_spd_solve(int device, const float* A, const float* b, int B, int R, float* x, int route,
                  int warps, float* workspace, int slots, void* stream, void* ev_start,
                  void* ev_end) {
  if (B <= 0 || R <= 0 || route < 0 || route > 2 ||
      (route == 0 && (warps < 1 || warps > SOLVE_MAX_WARPS || R > SOLVE_CHUNK)) ||
      (route != 0 && warps != SOLVE_BLOCK_WARPS) ||
      (route == 2 && (workspace == nullptr || slots < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ws = solve_ws_floats(R);
  const long long smem = static_cast<long long>(sizeof(float)) *
                         (route == 0 ? warps * ws : route == 1 ? ws + SOLVE_SCALARS : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = record_event(ev_start, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (route == 0) {
    const long long blocks = (static_cast<long long>(B) + warps - 1) / warps;
    spd_solve_warp_kernel<<<static_cast<unsigned>(blocks), warps * 32,
                            static_cast<size_t>(smem), s>>>(A, b, x, B, R);
  } else if (route == 1) {
    spd_solve_block_kernel<true><<<static_cast<unsigned>(B), SOLVE_BLOCK_WARPS * 32,
                                   static_cast<size_t>(smem), s>>>(A, b, x, B, R, nullptr);
  } else {
    spd_solve_block_kernel<false><<<static_cast<unsigned>(std::min(slots, B)),
                                    SOLVE_BLOCK_WARPS * 32, 0, s>>>(A, b, x, B, R, workspace);
  }
  return launched(ev_end, s);
}

}  // extern "C"
