// The two kernels of an ALS half-step, written for Hopper (sm_90a):
//
//   assemble_kernel             replaces predictionio_tpu/ops/als_pallas.py::
//                               assemble_normal_equations (kernel _kernel),
//                               also under the config grid's vmap
//   assemble_large_rank_kernel  the same, above assemble_kernel's rank limit
//   spd_solve_warp_kernel       replaces predictionio_tpu/ops/als_pallas.py::
//                               spd_solve (kernel _spd_solve_kernel)
//
// assemble_kernel. For each solve row b with slots l < L it gathers
// y_l = Y[cols[b, l]] and writes
//   A[b] = gram + sum_l aw[b, l] * y_l y_l^T      b[b] = sum_l bw[b, l] * y_l
// in fp32 FMAs (no tensor cores, no TF32: the reference pins
// Precision.HIGHEST). Nothing [B, L, R]-sized ever reaches device
// memory: each block gathers its slots' factor rows into shared memory,
// which is what the TPU kernel's VMEM gather bought. Rank is taken as
// given (the TPU kernel padded it to 128 for DMA alignment), up to what
// one block holds (pio_assemble_max_rank: 208 on an H100); above that the
// host launches assemble_large_rank_kernel, which takes any rank.
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
//
// spd_solve_warp_kernel. One warp solves one system A x = b: non-pivoted
// Cholesky A = U^T U on the upper triangle, with the pivot clamped at
// max(d, 1e-30) as in the TPU kernel, then U^T y = b and U x = y by
// column sweeps. The warp first copies A's upper triangle into its
// workspace, packed row by row, with every load in flight at once; U then
// overwrites it in place. The factorization is up-looking: row i of U is
// summed in registers (lane l holds columns w + l + 32m, m < 8, of a
// 256-column window from the 32-column group w that holds the diagonal;
// a longer row loops over windows) from a_ij and the rows k < i of U, the
// k loop running over the window's column groups inside the matrix alone.
// Rows go in pairs, which share each u_kj the k loop loads. Up to rank
// 256 the sweeps keep v in registers. Every entry takes the
// plain version's operations in its order, each product rounded before
// its subtraction (__fmul_rn / __fsub_rn, no FMA contraction), so the
// result is bitwise equal to it. No block barrier: lanes meet at
// __syncwarp and shuffles. The workspace holds the packed upper triangle
// and v, T(R) + R floats (R = 64: 8.6 KB), in shared memory when the
// host's plan fits two or more a block, else in device memory (fixed
// slots, each warp looping over systems), so only memory limits the
// rank. The TPU kernel's batch-on-lanes layout is a TPU device and is not
// copied.
// Bound on this card: B * (R(R+1)/2 + 2R) * 4 bytes (the upper triangle
// of A, b and x) at 3.35 TB/s against B * (R^3/3 + 2R^2) fp32
// operations; the bytes bind.

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
constexpr int LR_TILE = 32;          // assemble_large_rank_kernel: 32 x 32 tiles of A
constexpr int LR_THREADS = 256;      // ... 4 entries a thread
constexpr int LR_SLOTS = 32;         // ... slots staged at a time
constexpr int SOLVE_MAX_WARPS = 8;   // spd_solve_warp_kernel: warps (systems) a block
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

// A factor of Y as fp32: Y is float, or bf16 held as its 16 bits
// (uint16_t), which are the high half of the fp32 value.
__device__ __forceinline__ float load_factor(const float* p) { return __ldg(p); }
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
template <typename T, int MAX_THREADS, int MIN_BLOCKS>
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
  const int rs = shape.rs, rt = shape.rt, tiles = shape.tiles, items = shape.items;
  const int groups = shape.groups;
  const int nsub = grouped ? groups : 1;  // lists of live slots per chunk
  const int sub = ASM_CHUNK / nsub;       // slots of one list
  float* ys = smem;  // [2][ASM_CHUNK][rs]; after the slots, [groups - 1][items][64]
  float* red = smem;
  int* scol = reinterpret_cast<int*>(smem + max(2 * ASM_CHUNK * rs, (groups - 1) * items * 64));
  float* saw = reinterpret_cast<float*>(scol + ASM_META * ASM_CHUNK);
  float* sbw = saw + ASM_META * ASM_CHUNK;
  int* snlive = reinterpret_cast<int*>(sbw + ASM_META * ASM_CHUNK);  // [ASM_META][nsub]

  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int g = tid / items, it = tid - g * items;
  const bool worker = tid < shape.workers;
  const long long n_tasks = static_cast<long long>(B) * n_spans;
  const long long task = grouped ? blockIdx.x * static_cast<long long>(groups) + g : blockIdx.x;
  const int l_begin = grouped ? 0 : static_cast<int>(blockIdx.x % n_spans) * W;
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
    const long long t = grouped ? blockIdx.x * static_cast<long long>(groups) + j : blockIdx.x;
    const bool in = t < n_tasks;
    const long long base = in ? (t / n_spans) * L + l_begin : 0;
    for (int u = tid; u < lj; u += blockDim.x) {
      cp_async4(mcol + j * lj + u, cols + base + u, in ? 4 : 0);
      cp_async4(maw + j * lj + u, aw + base + u, in ? 4 : 0);
      cp_async4(mbw + j * lj + u, bw + base + u, in ? 4 : 0);
    }
  }
  cp_async_commit();

  const bool is_b = it >= tiles;
  int ti = is_b ? it - tiles : 0, tj = 0;
  if (!is_b) {
    int p = it;
    while (p >= rt - ti) {
      p -= rt - ti;
      ++ti;
    }
    tj = ti + p;
  }
  const int i0 = ti * 8, j0 = tj * 8;
  const int si = skew(i0), sj = skew(j0);  // their segments in a gathered row

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
    const int m = c % ASM_META, m0 = m * ASM_CHUNK;
    int first_half = 0;  // the one list's live slots in positions 0..31
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 32 * h + lane, j = p * nsub / ASM_CHUNK, u = c * sub + p - j * sub;
      const int k = j * lj + u;
      const float a = u < lj ? maw[k] : 0.f, w = u < lj ? mbw[k] : 0.f;
      const bool live = a != 0.f || w != 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      const unsigned seg = sub >= 32 ? 0xffffffffu : 0xffffu << (lane & 16);
      const int before = h == 1 && sub == ASM_CHUNK ? first_half : 0;
      if (live) {
        const int s = m0 + j * sub + before + __popc(ballot & seg & below);
        scol[s] = mcol[k];
        saw[s] = a;
        sbw[s] = w;
      }
      const int count = __popc(ballot & seg);
      if (sub == ASM_CHUNK) {
        if (h == 0)
          first_half = count;
        else if (lane == 0)
          snlive[m * nsub] = first_half + count;
      } else if (lane % sub == 0) {
        snlive[m * nsub + j] = count;
      }
    }
  };
  // each warp copies whole factor rows, spw rows a pass, lane lq of a row
  // taking copies lq, lq + qstep, ... of 16 bytes (or one factor)
  const int per = gvec ? R / kWidth : R;
  const int spw = per >= 32 ? 1 : 32 / per;
  const int lrow = per >= 32 ? 0 : lane / per, lq = lane - lrow * per;
  const int qstep = per >= 32 ? 32 : per, warp = tid >> 5, n_warps = blockDim.x >> 5;
  auto gather = [&](int c) {  // factor rows of chunk c's live slots
    const int m = c % ASM_META, m0 = m * ASM_CHUNK;
    float* dst = ys + (c & 1) * ASM_CHUNK * rs;
    if (lrow >= spw) return;
    for (int s = warp * spw + lrow; s < ASM_CHUNK; s += n_warps * spw) {
      const int j = s * nsub / ASM_CHUNK;
      if (s - j * sub >= snlive[m * nsub + j]) continue;  // past the list's live slots
      const int col = scol[m0 + s];
      const bool ok = col >= 0 && col < M;
      const T* src = ok ? Y + static_cast<long long>(col) * R : Y;
      for (int q = lq; q < per; q += qstep) {
        if constexpr (kF32) {
          if (gvec)
            cp_async16(dst + s * rs + skew(4 * q), src + 4 * q, ok ? 16 : 0);
          else
            cp_async4(dst + s * rs + skew(q), src + q, ok ? 4 : 0);
        } else if (gvec) {  // 8 bf16 values -> 8 fp32 (one 32-column group: no skew inside)
          const uint4 u = ok ? __ldg(reinterpret_cast<const uint4*>(src + 8 * q))
                             : make_uint4(0u, 0u, 0u, 0u);
          float4* d = reinterpret_cast<float4*>(dst + s * rs + skew(8 * q));
          d[0] = make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
          d[1] = make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w));
        } else {
          dst[s * rs + skew(q)] = ok ? load_factor(src + q) : 0.f;
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
    const float* yb = ys + (c & 1) * ASM_CHUNK * rs;
    const int s0 = grouped ? g * sub : g, step = grouped ? 1 : groups;
    const int s_end = !worker ? s0 : grouped ? g * sub + snlive[m * nsub + g] : snlive[m * nsub];
    const float* wts = (is_b ? sbw : saw) + m * ASM_CHUNK;
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
// (R <= 64), else for one.
template <typename T, typename... Args>
void launch_assemble(unsigned blocks, unsigned configs, const AsmShape& shape, cudaStream_t s,
                     const T* Y, Args... args) {
  const dim3 grid(blocks, configs);
  if (shape.threads <= ASM_SMALL_THREADS)
    assemble_kernel<T, ASM_SMALL_THREADS, 3>
        <<<grid, shape.threads, shape.smem_bytes, s>>>(Y, args...);
  else
    assemble_kernel<T, ASM_MAX_THREADS, 1>
        <<<grid, shape.threads, shape.smem_bytes, s>>>(Y, args...);
}

// assemble_large_rank_kernel: the assembly above pio_assemble_max_rank.
// Block (row, y) with y < tiles sums the 32 x 32 tile (ti, tj), ti <= tj,
// of A's upper triangle; block (row, tiles) sums b. Each of the 256
// threads holds 4 entries of the tile (column c = tid & 31, rows
// tid >> 5 + 8q). Slots come 32 at a time: their factor segments y[i0..]
// (times aw) and y[j0..] are read through L2 into shared memory, then
// summed in fp32 FMAs as in assemble_kernel (w * y_i first, then the FMA
// with y_j). The tile's upper entries are written with gram added, and
// mirrored into the lower triangle. Simple and correct first: every tile
// block re-reads the row's slots. Y fp32 or bf16 (load_factor).
template <typename T>
__global__ void __launch_bounds__(LR_THREADS)
assemble_large_rank_kernel(const T* __restrict__ Y, int M, int R,
                           const int* __restrict__ cols, const float* __restrict__ aw,
                           const float* __restrict__ bw, int L, const float* __restrict__ gram,
                           float* __restrict__ out_A, float* __restrict__ out_b) {
  __shared__ float yi[LR_SLOTS][LR_TILE];
  __shared__ float yj[LR_SLOTS][LR_TILE];
  const long long row = blockIdx.x;
  const int rt = (R + LR_TILE - 1) / LR_TILE, tiles = rt * (rt + 1) / 2;
  const int tid = threadIdx.x;
  const int* rc = cols + row * L;
  const float* ra = aw + row * L;
  const float* rb = bw + row * L;
  if (static_cast<int>(blockIdx.y) == tiles) {  // b: thread t owns entries t, t + 256, ...
    for (int e = tid; e < R; e += LR_THREADS) {
      float acc = 0.f;
      for (int l = 0; l < L; ++l) {
        const float w = rb[l];
        const int c = rc[l];
        if (w != 0.f && c >= 0 && c < M)
          acc = fmaf(w, load_factor(Y + static_cast<long long>(c) * R + e), acc);
      }
      out_b[row * R + e] = acc;
    }
    return;
  }
  int p = blockIdx.y, ti = 0;
  while (p >= rt - ti) {
    p -= rt - ti;
    ++ti;
  }
  const int tj = ti + p, i0 = LR_TILE * ti, j0 = LR_TILE * tj;
  const int c = tid & 31, a0 = tid >> 5;
  float acc[LR_TILE * LR_TILE / LR_THREADS] = {};
  for (int l0 = 0; l0 < L; l0 += LR_SLOTS) {
    for (int e = tid; e < LR_SLOTS * LR_TILE; e += LR_THREADS) {
      const int s = e / LR_TILE, cc = e % LR_TILE, l = l0 + s;
      const float w = l < L ? ra[l] : 0.f;
      const int col = l < L ? rc[l] : -1;
      const bool ok = w != 0.f && col >= 0 && col < M;
      const T* y = Y + static_cast<long long>(ok ? col : 0) * R;
      yi[s][cc] = ok && i0 + cc < R ? w * load_factor(y + i0 + cc) : 0.f;
      yj[s][cc] = ok && j0 + cc < R ? load_factor(y + j0 + cc) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < LR_SLOTS; ++s) {
      const float y = yj[s][c];
#pragma unroll
      for (int q = 0; q < LR_TILE * LR_TILE / LR_THREADS; ++q)
        acc[q] = fmaf(yi[s][a0 + 8 * q], y, acc[q]);
    }
    __syncthreads();
  }
  float* oA = out_A + row * R * R;
  const int j = j0 + c;
#pragma unroll
  for (int q = 0; q < LR_TILE * LR_TILE / LR_THREADS; ++q) {
    const int i = i0 + a0 + 8 * q;
    if (i >= R || j >= R || j < i) continue;  // the lower entries are the mirror's
    oA[i * R + j] = gram[i * R + j] + acc[q];
    if (i != j) oA[j * R + i] = gram[j * R + i] + acc[q];
  }
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

// The same sweeps for any R, with v in the workspace: v[j] stays with
// lane j & 31 throughout; only y_k (x_k) crosses lanes, by a shuffle
// from the lane that holds v[k].
__device__ __forceinline__ void solve_sweeps_workspace(const float* U, float* v, const float* bs,
                                                       float* xs, int R, int lane) {
  for (int j = lane; j < R; j += 32) v[j] = bs[j];
  for (int k = 0, offk = 0; k < R; offk += R - k, ++k) {  // U^T y = b
    float yk = 0.f;
    if (lane == (k & 31)) yk = v[k] / U[offk];
    yk = __shfl_sync(0xffffffffu, yk, k & 31);
    const float* Uk = U + offk - k;
    for (int j = (k & ~31) + lane; j < R; j += 32) {
      if (j == k)
        v[j] = yk;
      else if (j > k)
        v[j] = __fsub_rn(v[j], __fmul_rn(Uk[j], yk));
    }
  }
  for (int k = R - 1; k >= 0; --k) {  // U x = y
    float xk = 0.f;
    if (lane == (k & 31)) xk = v[k] / U[packed_off(k, R)];
    xk = __shfl_sync(0xffffffffu, xk, k & 31);
    for (int i = lane; i <= k; i += 32) {
      if (i == k)
        v[i] = xk;
      else
        v[i] = __fsub_rn(v[i], __fmul_rn(U[packed_off(i, R) + k - i], xk));
    }
  }
  for (int j = lane; j < R; j += 32) xs[j] = v[j];
}

// spd_solve_warp_kernel: one warp solves one system; kShared puts the
// warp's workspace in shared memory (warp w of the block at w * ws), else
// in device memory, one slot per warp of the grid. Systems go to warps
// sys = w, w + n_warps, ...; with kShared the grid covers B and the loop
// runs once.
template <bool kShared>
__global__ void __launch_bounds__(SOLVE_MAX_WARPS * 32)
spd_solve_warp_kernel(const float* __restrict__ A, const float* __restrict__ b,
                      float* __restrict__ x, int B, int R, float* __restrict__ ws_dev) {
  static_assert(SOLVE_MC == 8, "solve_row_window is dispatched for 1..8 column groups");
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ws = solve_ws_floats(R);
  const long long gw = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const long long n_warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  float* U = kShared ? smem + warp * ws : ws_dev + gw * ws;  // row i at off(i)
  for (long long sys = gw; sys < B; sys += n_warps) {
    const float* As = A + sys * R * R;
    // A's upper triangle into the workspace, packed as U will be, every
    // load in flight at once (cp.async into shared memory): the rows
    // then wait on no device-memory load, and U overwrites A in place.
    for (int i = 0, offi = 0; i < R; offi += R - i, ++i)
      for (int j = i + lane; j < R; j += 32) {
        if (kShared)
          cp_async4(U + offi + j - i, As + static_cast<long long>(i) * R + j, 4);
        else
          U[offi + j - i] = __ldg(As + static_cast<long long>(i) * R + j);
      }
    if (kShared) {
      cp_async_commit();
      cp_async_wait<0>();
    }
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
    if (R <= SOLVE_CHUNK)
      solve_sweeps_registers(U, b + sys * R, x + sys * R, R, lane);
    else
      solve_sweeps_workspace(U, U + ws - R, b + sys * R, x + sys * R, R, lane);
    __syncwarp();  // the workspace is free for the warp's next system
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
      reinterpret_cast<const void*>(assemble_kernel<float, ASM_SMALL_THREADS, 3>),
      reinterpret_cast<const void*>(assemble_kernel<float, ASM_MAX_THREADS, 1>),
      reinterpret_cast<const void*>(assemble_kernel<uint16_t, ASM_SMALL_THREADS, 3>),
      reinterpret_cast<const void*>(assemble_kernel<uint16_t, ASM_MAX_THREADS, 1>),
      reinterpret_cast<const void*>(spd_solve_warp_kernel<true>)};
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
// K configurations (K = 1: one config, gridDim.y = 1).
template <typename T>
int assemble_entry(int device, const T* Y, int K, int M, int R, const int* cols, const float* aw,
                   const float* bw, int B, int L, int span, int n_spans, int grouped,
                   const float* gram, float* A, float* b, float* partial, void* stream,
                   void* ev_start, void* ev_end) {
  if (K <= 0 || K > 65535 || B <= 0 || R <= 0 || L < 0 || M <= 0 || span <= 0 ||
      span % ASM_CHUNK != 0 || n_spans < 1 || static_cast<long long>(n_spans) * span < L ||
      (n_spans > 1 && (static_cast<long long>(n_spans - 1) * span >= L || partial == nullptr ||
                       grouped)))
    return static_cast<int>(cudaErrorInvalidValue);
  const AsmShape shape = asm_shape(R);
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
  if (n_spans == 1) {
    const long long blocks = grouped ? (B + shape.groups - 1) / shape.groups : B;
    launch_assemble(static_cast<unsigned>(blocks), static_cast<unsigned>(K), shape, s, Y, M, R,
                    cols, aw, bw, B, L, span, 1, grouped ? 1 : 0, gram, A, b, rr,
                    static_cast<long long>(R), shape, vec, cfg);
    return launched(ev_end, s);
  }
  const CfgStrides split{cfg.y, cfg.w, 0, per_partial, per_partial};
  launch_assemble(static_cast<unsigned>(static_cast<long long>(B) * n_spans),
                  static_cast<unsigned>(K), shape, s, Y, M, R, cols, aw, bw, B, L, span, n_spans,
                  0, static_cast<const float*>(nullptr), partial, partial + rr, rr + R, rr + R,
                  shape, vec, split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  assemble_reduce_kernel<<<dim3(static_cast<unsigned>(B), static_cast<unsigned>(K)),
                           REDUCE_THREADS, 0, s>>>(partial, n_spans, R, gram, A, b, per_partial,
                                                   cfg);
  return launched(ev_end, s);
}

// pio_assemble_large_rank for a factor store of type T.
template <typename T>
int assemble_large_rank_entry(int device, const T* Y, int M, int R, const int* cols,
                              const float* aw, const float* bw, int B, int L, const float* gram,
                              float* A, float* b, void* stream, void* ev_start, void* ev_end) {
  const long long rt = (R + LR_TILE - 1) / LR_TILE;
  if (B <= 0 || R <= 0 || L < 0 || M <= 0 || rt * (rt + 1) / 2 + 1 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = record_event(ev_start, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(rt * (rt + 1) / 2 + 1));
  assemble_large_rank_kernel<T><<<grid, LR_THREADS, 0, s>>>(Y, M, R, cols, aw, bw, L, gram, A, b);
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
                                       const float* gram, float* A, float* b, float* partial,
                                       void* stream, void* ev_start, void* ev_end) {
  if (y_dtype == 0)
    return assemble_entry(device, static_cast<const float*>(Y), K, M, R, cols, aw, bw, B, L,
                          span, n_spans, grouped, gram, A, b, partial, stream, ev_start, ev_end);
  if (y_dtype == 1)
    return assemble_entry(device, static_cast<const uint16_t*>(Y), K, M, R, cols, aw, bw, B, L,
                          span, n_spans, grouped, gram, A, b, partial, stream, ev_start, ev_end);
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
// one per slot group. R at most pio_assemble_max_rank(device), for either
// factor type. Launches on `stream`; returns cudaGetLastError(). ev_start
// / ev_end, when not null, are CUDA events recorded on `stream` around
// the kernels (no synchronisation here).
int pio_assemble_normal_equations(int device, const void* Y, int y_dtype, int M, int R,
                                  const int* cols, const float* aw, const float* bw, int B, int L,
                                  int span, int n_spans, int grouped, const float* gram, float* A,
                                  float* b, float* partial, void* stream, void* ev_start,
                                  void* ev_end) {
  return pio_assemble_normal_equations_grid(device, Y, y_dtype, 1, M, R, cols, aw, bw, B, L,
                                            span, n_spans, grouped, gram, A, b, partial, stream,
                                            ev_start, ev_end);
}

// A [B, R, R] and b [B, R] as pio_assemble_normal_equations computes them,
// at any rank (the route above pio_assemble_max_rank): one
// assemble_large_rank_kernel block per (row, upper 32 x 32 tile of A) and
// one per row for b. Y fp32 (y_dtype 0) or bf16 (1). Launches on
// `stream`; returns cudaGetLastError(). ev_start / ev_end as in
// pio_assemble_normal_equations.
int pio_assemble_large_rank(int device, const void* Y, int y_dtype, int M, int R,
                            const int* cols, const float* aw, const float* bw, int B, int L,
                            const float* gram, float* A, float* b, void* stream, void* ev_start,
                            void* ev_end) {
  if (y_dtype == 0)
    return assemble_large_rank_entry(device, static_cast<const float*>(Y), M, R, cols, aw, bw,
                                     B, L, gram, A, b, stream, ev_start, ev_end);
  if (y_dtype == 1)
    return assemble_large_rank_entry(device, static_cast<const uint16_t*>(Y), M, R, cols, aw,
                                     bw, B, L, gram, A, b, stream, ev_start, ev_end);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [B, R] solving A x = b for A [B, R, R] (symmetric positive definite;
// the upper triangle is read) and b [B, R], fp32, contiguous, on
// `device`, which pio_als_solve_init has set up. The host's plan
// (spd_solve_plan in ops/als_cuda.py) gives the route: `shared` puts
// each warp's workspace in shared memory, `warps` systems a block; else
// `workspace` holds `slots` workspaces of solve_ws_floats(R) in device
// memory (slots a multiple of `warps`), one per warp of the grid. Launches
// on `stream`; returns cudaGetLastError(). ev_start / ev_end as in
// pio_assemble_normal_equations.
int pio_spd_solve(int device, const float* A, const float* b, int B, int R, float* x, int shared,
                  int warps, float* workspace, int slots, void* stream, void* ev_start,
                  void* ev_end) {
  if (B <= 0 || R <= 0 || warps < 1 || warps > SOLVE_MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ws_bytes = solve_ws_floats(R) * static_cast<long long>(sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (warps * ws_bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  } else if (workspace == nullptr || slots < warps || slots % warps != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = record_event(ev_start, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared) {
    const long long blocks = (static_cast<long long>(B) + warps - 1) / warps;
    spd_solve_warp_kernel<true><<<static_cast<unsigned>(blocks), warps * 32,
                                  static_cast<size_t>(warps * ws_bytes), s>>>(A, b, x, B, R,
                                                                              nullptr);
  } else {
    spd_solve_warp_kernel<false><<<static_cast<unsigned>(slots / warps), warps * 32, 0, s>>>(
        A, b, x, B, R, workspace);
  }
  return launched(ev_end, s);
}

}  // extern "C"
