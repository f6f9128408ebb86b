// Fused score -> mask -> top-k for the serving path, written for Hopper
// (sm_90a). Replaces the TPU kernel
// predictionio_tpu/ops/als_pallas.py::fused_gather_score_topk.
//
// For queries Q [B, R] (fp32) and an item table Y [M, R] (fp32, bf16, or
// int8 with one fp32 scale per row) it returns, per query, the k largest
// scores Y . q in descending order with their item ids. Rows with
// id >= n_items, rows whose row_valid <= 0 and each query's seen items
// score -inf. Among equal scores the lowest item id comes first.
//
// The TPU kernel walks the item tiles in order and carries a running
// top-k in VMEM from one grid step to the next. Blocks on this card run
// in no order, so the work is split in two passes. For k up to 128 on
// rows wider than 2,048 items in batches of CHUNKED_MAX_B (32) queries
// or more (the host's plan), the tiled route keeps the first pass on
// chip:
//
//   0. tiled: score_select_tile_kernel, one block per (16 queries x
//      1,024 items), two blocks an SM (110,784 bytes of shared memory
//      each), scores its tile with register-tiled fp32 FMAs (8 queries x
//      4 items a thread at a time, the item rows staged by cp.async a
//      half-chunk and one 32-byte sector a row per step), turns each
//      score into its key in shared memory, masked by the padding rows,
//      row_valid and a [B, M / 32] seen bitmap (seen_bits_kernel; the
//      TPU kernel compared every tile with all L seen slots, here a block
//      reads 32 words a query), and selects each query's chunk winners
//      there, a warp per query: a threshold from the maxima of each 4
//      items' keys, the keys above it compacted in item order, a
//      rank-count or warp radix select over them. The winners go to a
//      candidate row per query as the chunked route's do (below), and the
//      same merge picks the k; the route returns exactly what the chunked
//      and bitonic routes return. No [B, M] buffer exists; at B = 256, M
//      = 26,744 the blocks are 27 chunks x 16 tiles.
//
//   1. score_tile_kernel: one block per (64 items x 16 queries) tile
//      computes the scores with fp32 FMAs (no tensor cores, no TF32:
//      the reference pins Precision.HIGHEST), widening bf16 and scaling
//      int8 rows as they are loaded, masks padding and invalid rows, and
//      writes the [B, M] score matrix. seen_mask_kernel then scatters
//      -inf into each query's seen ids: O(L*B) work, where the TPU kernel
//      compared every tile against all L seen slots.
//   2. The selection orders each query's row by the route the host picks
//      (topk_sort_plan in ops/als_cuda.py):
//      - chunked (k up to 128 on rows wider than a chunk of 2,048 items,
//        in batches under CHUNKED_MAX_B queries, as for every personal
//        top-N query; larger batches take the tiled route): the TPU
//        kernel selects each
//        item tile as it is scored and merges it into a running top-k;
//        here every chunk is selected at once, each by its own block
//        (select_chunk_kernel: the chunk's scores copied once into shared
//        memory, its min(k, n_c) winners selected there as below and
//        ordered by item id), into a candidate row per query in device
//        memory; then select_bitonic_kernel, one block per query, selects
//        and sorts the k winners of that row and maps positions to ids.
//        Invariant: along a candidate row, positions ascend with item ids
//        (chunks in order, each in id order, every chunk but the last
//        giving k), so the merge's (key desc, position asc) is (score
//        desc, id asc), and the top k of the row lies in the union of the
//        chunks' top k: the route returns exactly what the bitonic route
//        returns. At M = 26,744 that is 14 blocks per query instead of
//        one, each reading its 8 KB chunk once, and a merge over 224
//        candidates at k = 16 (1,784 at k = 128);
//      - bitonic (k up to 2,048 where neither the chunked nor the tiled
//        route applies):
//        select_bitonic_kernel finds the k-th largest score by an
//        MSB-first radix select over order-preserving 32-bit keys (a
//        second select over ids resolves ties at the threshold to the
//        lowest ids), gathers the k winners and sorts them by (score
//        desc, id asc) with a bitonic network in shared memory. The
//        select's digit search between passes is one warp's scan; its
//        passes read the row from device memory (5 walks with ties);
//      - cluster_row (wider k, as for category queries, which ask for
//        nearly every item): no select; sort_row_cluster_kernel sorts the
//        whole masked row with a stable LSD radix sort, four 8-bit passes
//        over the inverted keys, and keeps the first k. A cluster of 8
//        blocks on 8 SMs holds the row, an eighth of the pairs in each
//        block's shared memory, and each pass's scatter crosses blocks
//        through distributed shared memory. The row enters in id order
//        and the sort is stable, so the lowest id stays first among equal
//        scores with no second key. Each pass ranks tiles of 2,048 pairs,
//        four a thread, finding equal digits in a warp with eight ballots;
//      - radix_row: the same sort by one block (sort_row_kernel) through
//        a device-memory scratch that stays mostly in L2, for a row wider
//        than the cluster's shared memory holds (about 108,000 items on
//        an H100).
//
// Bound on this card: the item table is read once (M*R*bytes(dtype)) and
// the product is 2*B*M*R fp32 FMAs at the non-tensor fp32 rate; at B=1 the
// bytes bound it, at B=256 the operations do. Outside the tiled route the
// [B, M] score matrix makes one round trip through device memory (about
// 27 MB at B=256, M=26,744; under 1 MB at B <= 8, which stays in L2),
// which the TPU design avoided; the chunked route reads it once more and
// adds the candidate rows (B * cands * 8 bytes). The tiled route moves
// the candidate rows and the bitmap only, and reads the item table once
// per 16 queries (from L2). The whole-row sort replaces a
// bitonic network that ran log2(N)(log2(N)+1)/2 = 120 block-wide passes
// through device memory at N = 32,768: a radix pass touches each pair
// twice with two block barriers per 2,048 pairs, and a pass whose digit
// is the same for every key is skipped. A query's whole row is sorted
// by 8 SMs, not one: at B = 1 one block alone took about 3x as long on
// an H100.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TM = 64;          // items per score tile
constexpr int TB = 16;          // queries per score tile
constexpr int RC = 32;          // rank chunk held in shared memory
constexpr int SCORE_THREADS = 256;
constexpr int SELECT_THREADS = 1024;  // the bitonic route and the chunked route's merge
constexpr int CHUNK_THREADS = 512;    // the chunked route's chunk select
constexpr int CHUNK_K_MAX = 128;      // the widest k of the chunked route
constexpr int TOPK_CHUNK = 2048;      // items per chunk (8 KB of shared scores)
constexpr int RADIX_THREADS = 512;    // the whole-row routes
constexpr int RADIX_WARPS = RADIX_THREADS / 32;
constexpr int RADIX_SUB = 4;          // keys a thread ranks in each tile of a pass
constexpr int RADIX_TILE = RADIX_THREADS * RADIX_SUB;
constexpr int MAX_DEVICES = 64;

// Sort routes of the selection, as the host's topk_sort_plan names them.
constexpr int ROUTE_BITONIC = 0;      // select, gather, bitonic sort of k
constexpr int ROUTE_CLUSTER_ROW = 1;  // radix sort of the whole row by a cluster
constexpr int ROUTE_RADIX_ROW = 2;    // the same by one block, in device memory
constexpr int ROUTE_CHUNKED = 3;      // a select per chunk, then a merge per query
constexpr int ROUTE_TILED = 4;        // score and select a chunk per block, then a merge
constexpr int SORT_CLUSTER = 8;       // blocks of a cluster that sorts one row

// The tiled route (score_select_tile_kernel): one block per (TILE_Q
// queries x TILE_CHUNK items), TILE_THREADS threads. A thread scores
// TILE_QT queries x TILE_J items (items ig + TILE_IG * j, the first
// TILE_J / 2 in the chunk's first half). Each step stages, through
// cp.async one step ahead, one half of the chunk (TILE_HALF items) at
// TileIn<T>::kRB ranks: 32 bytes of each row (fp32, bf16), one sector,
// two lanes a row.
constexpr int TILE_Q = 16;
constexpr int TILE_CHUNK = 1024;
constexpr int TILE_HALF = TILE_CHUNK / 2;
constexpr int TILE_THREADS = 256;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int TILE_QT = 8;                            // queries a thread
constexpr int TILE_IG = TILE_THREADS / (TILE_Q / TILE_QT);  // item groups
constexpr int TILE_J = TILE_CHUNK / TILE_IG;          // items a thread, TILE_J / 2 a half
constexpr int TILE_RB_MAX = 16;                       // ranks a step (TileIn<T>::kRB)
constexpr int TILE_ROW = TILE_CHUNK + 2;              // a query's keys; +2 spreads the stores' banks
constexpr int TILE_GROUPS = TILE_IG * 2;              // maxima a query, each over 4 items
constexpr int TILE_CAND = TILE_GROUPS;                // candidates a warp holds for a query
constexpr int TILE_WORDS = TILE_CHUNK / 32;           // seen bitmap words a chunk
constexpr int TILE_SEEN_ROW = TILE_WORDS + 1;         // +1 spreads the reads' banks
constexpr int TILE_SLOT = TILE_HALF * 32;             // a step's items: 32 bytes an item
// dynamic shared memory, in bytes: the keys; the maxima' top 16 bits;
// the chunk's seen words; two rank blocks' query slices; then the
// staging region: two slots of a step's items as loaded (int8: an fp32
// slot and two raw ones); after scoring, the warps' histograms and
// candidates
constexpr int TILE_KEYS_OFF = 0;
constexpr int TILE_GMAX_OFF = TILE_KEYS_OFF + TILE_Q * TILE_ROW * 4;
constexpr int TILE_SEEN_OFF = TILE_GMAX_OFF + TILE_Q * TILE_GROUPS * 2;
constexpr int TILE_QS_OFF = TILE_SEEN_OFF + TILE_Q * TILE_SEEN_ROW * 4;
constexpr int TILE_STAGE_OFF = TILE_QS_OFF + 2 * TILE_Q * TILE_RB_MAX * 4;
constexpr int TILE_STAGE_BYTES = 2 * TILE_SLOT;
constexpr size_t TILE_SMEM = TILE_STAGE_OFF + TILE_STAGE_BYTES;
static_assert(TILE_GMAX_OFF % 16 == 0 && TILE_SEEN_OFF % 16 == 0 && TILE_QS_OFF % 16 == 0 &&
                  TILE_STAGE_OFF % 16 == 0, "16-byte regions");
static_assert(TILE_WARPS * (256 + 2 * TILE_CAND) * 4 <= TILE_STAGE_BYTES,
              "histograms and candidates fit the staging region");
static_assert(2 * TILE_WARPS == TILE_Q, "a warp selects two queries");
static_assert(TILE_J == 8 && TILE_IG * 4 == TILE_HALF,
              "a thread's items 0-3 lie in the first half, 4-7 in the second");

inline int next_pow2(int k) {
  int n = 1;
  while (n < k) n <<= 1;
  return n;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const int8_t* p, long long i) {
  return static_cast<float>(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(SCORE_THREADS)
score_tile_kernel(const float* __restrict__ Q, const T* __restrict__ Y,
                  const float* __restrict__ scale,
                  const float* __restrict__ row_valid,
                  float* __restrict__ S, int B, int M, int R, int n_items) {
  __shared__ float ys[TM][RC + 1];
  __shared__ float qs[TB][RC + 1];
  const int tid = threadIdx.x;
  const int tb = tid % TB;  // query within the tile
  const int tm = tid / TB;  // items tm, tm+16, tm+32, tm+48
  const int m0 = blockIdx.x * TM;
  const int b0 = blockIdx.y * TB;
  float acc[TM / 16] = {0.f, 0.f, 0.f, 0.f};

  for (int r0 = 0; r0 < R; r0 += RC) {
    for (int e = tid; e < TM * RC; e += SCORE_THREADS) {
      const int mm = e / RC, rr = e % RC, m = m0 + mm, r = r0 + rr;
      float v = 0.f;
      if (m < M && r < R) {
        v = load_f(Y, static_cast<long long>(m) * R + r);
        if (scale != nullptr) v *= scale[m];
      }
      ys[mm][rr] = v;
    }
    for (int e = tid; e < TB * RC; e += SCORE_THREADS) {
      const int bb = e / RC, rr = e % RC, b = b0 + bb, r = r0 + rr;
      qs[bb][rr] = (b < B && r < R) ? Q[static_cast<long long>(b) * R + r] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < RC; ++rr) {
      const float q = qs[tb][rr];
#pragma unroll
      for (int j = 0; j < TM / 16; ++j) acc[j] = fmaf(ys[tm + 16 * j][rr], q, acc[j]);
    }
    __syncthreads();
  }

  const int b = b0 + tb;
  if (b >= B) return;
#pragma unroll
  for (int j = 0; j < TM / 16; ++j) {
    const int m = m0 + tm + 16 * j;
    if (m < M) {
      const bool ok = m < n_items && (row_valid == nullptr || row_valid[m] > 0.f);
      S[static_cast<long long>(b) * M + m] = ok ? acc[j] : neg_inf();
    }
  }
}

__global__ void seen_mask_kernel(const int* __restrict__ cols,
                                 const float* __restrict__ mask,
                                 long long col_sl, long long col_sb,
                                 long long mask_sl, long long mask_sb,
                                 int L, int B, float* __restrict__ S, int M) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(L) * B) return;
  const long long l = e / B, b = e % B;
  const int c = cols[l * col_sl + b * col_sb];
  if (mask[l * mask_sl + b * mask_sb] > 0.f && c >= 0 && c < M) S[b * M + c] = neg_inf();
}

// Order-preserving key: a > b as floats <=> key(a) > key(b) as unsigned.
// -0.0 maps to the key of +0.0, so the two tie (and break by id).
__device__ __forceinline__ unsigned float_key(float f) {
  unsigned u = __float_as_uint(f);
  if (f == 0.f) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The lanes of this warp that hold the same digit d in 0..255 (d < 0:
// none, and such a lane is nobody's peer and has none): eight ballots, one
// per bit. In the radix sort, where every lane holds a digit, this is
// cheaper than __match_any_sync; in the select, where most lanes hold
// none, __match_any_sync is.
__device__ __forceinline__ unsigned digit_peers(int d) {
  unsigned peers = __ballot_sync(0xffffffffu, d >= 0);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned v = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? v : ~v;
  }
  return d >= 0 ? peers : 0u;
}

// Block-wide MSB-first radix select of the element of descending rank
// `rank` (1-based). With by_id false the keys are the scores' keys over
// the whole row; with by_id true the candidates are the elements whose
// score key equals `tie_key` and their key is ~id, so the select counts
// ids in ascending order. Returns T, where the `rank` largest keys are
// those > T and the *need largest of those == T; *eq receives the number
// of candidates == T. A pass that selects a digit whose every key is
// among the `rank` largest ends the select: T is then the digits so far
// with zero low bits, so the winners are exactly the keys >= T, and
// *need == *eq (every key == T wins; so do the keys above T in those
// low bits). Otherwise T is the exact key of rank `rank`.
__device__ unsigned radix_select(const float* row, int n, unsigned rank, bool by_id,
                                 unsigned tie_key, unsigned* hist, unsigned* sh,
                                 unsigned* need, unsigned* eq) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0u, pmask = 0u, remaining = rank, eq_count = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
    // every lane of a warp runs the same iterations, so the warp-wide
    // match below always sees a full warp
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      int bin = -1;
      if (i < n) {
        const unsigned sk = float_key(row[i]);
        if (!by_id || sk == tie_key) {
          const unsigned key = by_id ? ~static_cast<unsigned>(i) : sk;
          if ((key & pmask) == prefix) bin = static_cast<int>((key >> shift) & 255u);
        }
      }
      if (__any_sync(0xffffffffu, bin >= 0)) {  // after the first pass, most warps hold none
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // the digit: the highest d whose count, with all counts above it,
      // reaches `remaining`. Warp 0 scans the bins from the top, 8 a lane
      // (lane l holds 255 - 8l down to 248 - 8l), with shuffles; the one
      // lane whose range crosses `remaining` walks its 8 bins.
      unsigned c[8], s = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - lane * 8 - j];
        s += c[j];
      }
      unsigned inc = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      unsigned cum = inc - s;  // the counts of every bin above this lane's
      const bool mine = cum < remaining && remaining <= inc;
      if (mine) {
        bool found = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!found && cum + c[j] >= remaining) {
            found = true;
            sh[0] = static_cast<unsigned>(255 - lane * 8 - j);
            sh[1] = remaining - cum;
            sh[2] = c[j];
          }
          if (!found) cum += c[j];
        }
      }
      const unsigned total = __shfl_sync(0xffffffffu, inc, 31);
      if (__ballot_sync(0xffffffffu, mine) == 0u && lane == 0) {  // no digit: rank > n
        sh[0] = 0u;
        sh[1] = remaining - total;
        sh[2] = hist[0];
      }
    }
    __syncthreads();
    prefix |= sh[0] << shift;
    pmask |= 255u << shift;
    remaining = sh[1];
    eq_count = sh[2];
    if (eq_count == remaining) break;  // the digit's keys all win: no lower digit decides
  }
  *need = remaining;
  *eq = eq_count;
  return prefix;
}

// (key desc, id asc): does (ka, ia) come before (kb, ib)?
__device__ __forceinline__ bool before(unsigned ka, unsigned ia, unsigned kb, unsigned ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Shared state of the radix sort (RADIX_THREADS threads).
struct RadixSmem {
  unsigned hist[4][256];                     // digit counts of the four passes
  unsigned short wofs[RADIX_WARPS][256];     // per tile: digit count, then offset, per warp
  unsigned dbase[256];                       // next free slot of each digit in the pass
  unsigned tbase[256];                       // the tile's first slot of each digit
  unsigned skip[4];                          // pass p moves nothing
};

// One pass of the stable LSD radix sort over this block's n pairs (k0,
// i0) by the digit at `shift`: tiles of RADIX_TILE pairs in order, each
// warp a contiguous run of 32 * RADIX_SUB of them; a pair with digit d
// goes to sm.dbase[d] (which advances), plus the counts of d in the
// tile's earlier warps, plus its rank among the equal digits before it in
// its warp's run (digit_peers and a running count per digit), so equal
// keys keep their order. put(pos, key, id) stores a pair.
template <typename Put>
__device__ void scatter_pass(int n, const unsigned* k0, const unsigned* i0, int shift,
                             RadixSmem& sm, Put put) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < n; base += RADIX_TILE) {
    unsigned key[RADIX_SUB], id[RADIX_SUB], rank[RADIX_SUB];
    int d[RADIX_SUB];
    bool lead[RADIX_SUB];
#pragma unroll
    for (int q = 0; q < RADIX_SUB; ++q) {  // this warp's run, in order
      const int i = base + (warp * RADIX_SUB + q) * 32 + lane;
      const bool valid = i < n;
      key[q] = valid ? k0[i] : 0u;
      id[q] = valid ? i0[i] : 0u;
      d[q] = valid ? static_cast<int>((key[q] >> shift) & 255u) : -1;
      const unsigned peers = digit_peers(d[q]);
      lead[q] = valid && lane == __ffs(peers) - 1;
      const unsigned before = valid ? sm.wofs[warp][d[q]] : 0u;
      rank[q] = before + __popc(peers & below);
      __syncwarp();
      if (lead[q]) sm.wofs[warp][d[q]] = static_cast<unsigned short>(before + __popc(peers));
      __syncwarp();
    }
    __syncthreads();
    if (tid < 256) {  // digit tid: offsets of the tile's warps, in warp order
      unsigned run = 0u;
      for (int w = 0; w < RADIX_WARPS; ++w) {
        const unsigned c = sm.wofs[w][tid];
        if (c) {
          sm.wofs[w][tid] = static_cast<unsigned short>(run);
          run += c;
        }
      }
      sm.tbase[tid] = sm.dbase[tid];
      sm.dbase[tid] += run;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RADIX_SUB; ++q)
      if (d[q] >= 0) put(sm.tbase[d[q]] + sm.wofs[warp][d[q]] + rank[q], key[q], id[q]);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < RADIX_SUB; ++q)  // zero again for the next tile
      if (lead[q]) sm.wofs[warp][d[q]] = 0;
    __syncwarp();
  }
}

// Stable LSD radix sort of the n pairs (k0, i0) by key, descending: the
// keys are inverted once and sorted ascending in four 8-bit passes
// (scatter_pass) that ping-pong between (k0, i0) and (k1, i1). A pass
// whose digit is the same for every key is skipped. On return (k0, i0)
// hold the sorted pairs, keys inverted.
__device__ void radix_sort_desc(int n, unsigned*& k0, unsigned*& i0, unsigned*& k1,
                                unsigned*& i1, RadixSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < 4 * 256; e += blockDim.x) (&sm.hist[0][0])[e] = 0u;
  for (int e = tid; e < RADIX_WARPS * 256; e += blockDim.x) (&sm.wofs[0][0])[e] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {  // invert, count all four digits
    const int i = base + tid;
    unsigned key = 0u;
    if (i < n) {
      key = ~k0[i];
      k0[i] = key;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int d = i < n ? static_cast<int>((key >> (8 * p)) & 255u) : -1;
      const unsigned peers = digit_peers(d);
      if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&sm.hist[p][d], static_cast<unsigned>(__popc(peers)));
    }
  }
  __syncthreads();

  for (int p = 0; p < 4; ++p) {
    if (tid < 32) {  // exclusive scan of the pass's histogram, 8 digits a lane
      unsigned c[8], s = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sm.hist[p][lane * 8 + j];
        s += c[j];
      }
      unsigned inc = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      unsigned run = inc - s;
      bool whole = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sm.dbase[lane * 8 + j] = run;
        run += c[j];
        whole |= c[j] == static_cast<unsigned>(n);
      }
      whole = __any_sync(0xffffffffu, whole);
      if (lane == 0) sm.skip[p] = whole;
    }
    __syncthreads();
    if (sm.skip[p]) continue;
    scatter_pass(n, k0, i0, 8 * p, sm, [&](unsigned pos, unsigned key, unsigned id) {
      k1[pos] = key;
      i1[pos] = id;
    });
    unsigned* t = k0;
    k0 = k1;
    k1 = t;
    t = i0;
    i0 = i1;
    i1 = t;
  }
  __syncthreads();
}

// The k winners of row[0, n) are the keys > T and, of the keys == T, the
// positions <= *id_cut (all ones when every key == T wins): radix_select,
// and when some keys == T lose, a second select over their positions.
__device__ __forceinline__ unsigned select_winners(const float* row, int n, int k,
                                                   unsigned* hist, unsigned* sh,
                                                   unsigned* id_cut) {
  unsigned need, eq;
  const unsigned T = radix_select(row, n, static_cast<unsigned>(k), false, 0u, hist, sh,
                                  &need, &eq);
  // every key above T, and the `need` lowest positions at T
  *id_cut = 0xffffffffu;
  if (need < eq) {
    unsigned need2, eq2;
    *id_cut = ~radix_select(row, n, need, true, T, hist, sh, &need2, &eq2);
  }
  return T;
}

// The compare-exchanges of one stage (size, stride) of a bitonic network
// over skey/sid, spread over the block: by (key desc, position asc), or
// with ById by position alone, ascending.
template <bool ById>
__device__ __forceinline__ void bitonic_stage(unsigned* skey, unsigned* sid, int N, int size,
                                              int stride) {
  for (int t = threadIdx.x; t < N / 2; t += blockDim.x) {
    const int lo = (t / stride) * 2 * stride + (t % stride);
    const int hi = lo + stride;
    const unsigned ka = skey[lo], ia = sid[lo], kb = skey[hi], ib = sid[hi];
    const bool up = (lo & size) == 0;
    const bool swap = ById ? (up ? ib < ia : ia < ib)
                           : (up ? before(kb, ib, ka, ia) : before(ka, ia, kb, ib));
    if (swap) {
      skey[lo] = kb;
      sid[lo] = ib;
      skey[hi] = ka;
      sid[hi] = ia;
    }
  }
}

// Gathers the k winners of row[0, n) (select_winners) into skey/sid in any
// order, pads the slots [k, N) to sort last, and sorts the N pairs in
// shared memory with a bitonic network (bitonic_stage).
template <bool ById>
__device__ __forceinline__ void gather_and_sort(const float* row, int n, int k, int N,
                                                unsigned T, unsigned id_cut,
                                                unsigned* skey, unsigned* sid,
                                                unsigned* count) {
  if (threadIdx.x == 0) *count = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned key = float_key(row[i]);
    if (key > T || (key == T && static_cast<unsigned>(i) <= id_cut)) {
      const unsigned slot = atomicAdd(count, 1u);
      skey[slot] = key;
      sid[slot] = static_cast<unsigned>(i);
    }
  }
  for (int i = k + threadIdx.x; i < N; i += blockDim.x) {  // padding sorts last
    skey[i] = 0u;
    sid[i] = 0xffffffffu;
  }
  __syncthreads();
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      bitonic_stage<ById>(skey, sid, N, size, stride);
      __syncthreads();
    }
  }
}

// One block per query: select the k winners of the row's n scores, gather
// them and sort them by (key desc, position asc) in shared memory (width
// N = next_pow2(k)). The bitonic route runs it on the score rows (stride
// M, ids null: a position is an item id); the chunked route's merge on
// the candidate rows (stride 2 * pairs), whose position p holds item
// ids[p], ascending along the row.
__global__ void __launch_bounds__(SELECT_THREADS)
select_bitonic_kernel(const float* __restrict__ S, long long stride, int n, int k, int N,
                      const int* __restrict__ ids, float* __restrict__ vals,
                      int* __restrict__ idx) {
  extern __shared__ unsigned dyn[];
  __shared__ unsigned hist[256];
  __shared__ unsigned sh[4];
  const long long b = blockIdx.x;
  const float* row = S + b * stride;
  unsigned* skey = dyn;
  unsigned* sid = dyn + N;

  unsigned id_cut;
  const unsigned T = select_winners(row, n, k, hist, sh, &id_cut);
  gather_and_sort<false>(row, n, k, N, T, id_cut, skey, sid, &sh[3]);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    vals[b * k + j] = key_float(skey[j]);
    idx[b * k + j] = ids != nullptr ? ids[b * stride + sid[j]] : static_cast<int>(sid[j]);
  }
}

// The chunked route's first step, block x: chunk c = x % chunks (items
// [c * TOPK_CHUNK, c * TOPK_CHUNK + n_c), n_c <= TOPK_CHUNK) of query
// b = x / chunks.
// The block copies the chunk's scores into shared memory once, selects
// its k_c = min(k, n_c) winners there, orders them by item id, and
// writes them to candidate slots [c * k, c * k + k_c) of query b: the
// values (key_float of the key, so -0.0 is +0.0) in words [0, pairs) of
// the query's row of `cand`, the item ids in words [pairs, 2 * pairs).
// Every chunk but the last has k_c = k, so positions along a candidate
// row ascend with item ids.
__global__ void __launch_bounds__(CHUNK_THREADS)
select_chunk_kernel(const float* __restrict__ S, int M, int k, int chunks,
                    unsigned* __restrict__ cand, long long pairs) {
  __shared__ float srow[TOPK_CHUNK];
  __shared__ unsigned hist[256];
  __shared__ unsigned sh[4];
  __shared__ unsigned skey[CHUNK_K_MAX], sid[CHUNK_K_MAX];
  const int c = static_cast<int>(blockIdx.x % chunks);
  const long long b = blockIdx.x / chunks;
  const int lo = c * TOPK_CHUNK;
  const int n = min(TOPK_CHUNK, M - lo);
  const int kc = min(k, n);
  const float* row = S + b * M + lo;
  for (int i = threadIdx.x; i < n; i += blockDim.x) srow[i] = row[i];
  __syncthreads();
  unsigned id_cut;
  const unsigned T = select_winners(srow, n, kc, hist, sh, &id_cut);
  int N = 1;
  while (N < kc) N <<= 1;
  gather_and_sort<true>(srow, n, kc, N, T, id_cut, skey, sid, &sh[3]);
  unsigned* out = cand + b * 2 * pairs + static_cast<long long>(c) * k;
  for (int j = threadIdx.x; j < kc; j += blockDim.x) {
    out[j] = __float_as_uint(key_float(skey[j]));
    out[pairs + j] = static_cast<unsigned>(lo) + sid[j];
  }
}

// The tiled route's seen bitmap: bit m % 32 of word [b, m / 32] set for
// each slot (l, b) whose mask is > 0 and whose id m lies in [0, M). The
// words were zeroed on the stream before.
__global__ void seen_bits_kernel(const int* __restrict__ cols, const float* __restrict__ mask,
                                 long long col_sl, long long col_sb, long long mask_sl,
                                 long long mask_sb, int L, int B, unsigned* __restrict__ bits,
                                 int W, int M) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(L) * B) return;
  const long long l = e / B, b = e % B;
  const int c = cols[l * col_sl + b * col_sb];
  if (mask[l * mask_sl + b * mask_sb] > 0.f && c >= 0 && c < M)
    atomicOr(&bits[b * W + c / 32], 1u << (c & 31));
}

// One warp's MSB-first radix select of the element of descending rank
// `rank` (1-based, <= n) among n keys in shared memory, in at most
// `passes` 8-bit digits; hist is the warp's 256 counters. The contract of
// radix_select over keys: returns T with *need of the keys == T among the
// winners and *eq of them in all; a pass whose digit's keys all win ends
// the select, with T the digits so far and zero low bits. After fewer
// than four passes without that end, T is the digits so far with zero
// low bits, and the keys >= T include the `rank` largest.
__device__ unsigned warp_radix_select(const unsigned* keys, int n, unsigned rank, int passes,
                                      unsigned* hist, unsigned* need, unsigned* eq) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0u, pmask = 0u, remaining = rank, eq_count = 0u;
  for (int pass = 0, shift = 24; pass < passes; ++pass, shift -= 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) hist[lane * 8 + j] = 0u;
    __syncwarp();
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      int bin = -1;
      if (i < n) {
        const unsigned key = keys[i];
        if ((key & pmask) == prefix) bin = static_cast<int>((key >> shift) & 255u);
      }
      if (__any_sync(full, bin >= 0)) {
        const unsigned peers = __match_any_sync(full, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncwarp();
    // the digit, as in radix_select: lane l scans bins 255 - 8l down to
    // 248 - 8l; the lane whose range crosses `remaining` walks them
    unsigned c[8], s = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[255 - lane * 8 - j];
      s += c[j];
    }
    unsigned inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(full, inc, o);
      if (lane >= o) inc += v;
    }
    unsigned cum = inc - s, digit = 0u, rem = 0u, cnt = 0u;
    const bool mine = cum < remaining && remaining <= inc;
    if (mine) {
      bool found = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!found && cum + c[j] >= remaining) {
          found = true;
          digit = static_cast<unsigned>(255 - lane * 8 - j);
          rem = remaining - cum;
          cnt = c[j];
        }
        if (!found) cum += c[j];
      }
    }
    const unsigned who = __ballot_sync(full, mine);
    const unsigned total = __shfl_sync(full, inc, 31);
    if (who != 0u) {
      const int src = __ffs(who) - 1;
      digit = __shfl_sync(full, digit, src);
      rem = __shfl_sync(full, rem, src);
      cnt = __shfl_sync(full, cnt, src);
    } else {  // rank > n: no digit (callers never ask)
      rem = remaining - total;
      cnt = hist[0];
    }
    __syncwarp();  // every lane has read the counters before the next pass clears them
    prefix |= digit << shift;
    pmask |= 255u << shift;
    remaining = rem;
    eq_count = cnt;
    if (eq_count == remaining) break;
  }
  *need = remaining;
  *eq = eq_count;
  return prefix;
}

// cp.async of `bytes` (16, 8 or 4) from global to shared memory; the
// first src_bytes are copied and the rest zero-filled (src_bytes 0: zeros)
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(Bytes), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A value of type T with all bits zero (0.0 for fp32 and bf16).
template <typename T>
__device__ __forceinline__ T zero_of() {
  T z;
  unsigned char* b = reinterpret_cast<unsigned char*>(&z);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)); ++i) b[i] = 0;
  return z;
}

// How a step's items reach the FMAs, by store type: kRB ranks a step,
// kRaw bytes an item a step in its landing slot (consecutive items
// consecutive), and quad(slot, it, d), the fp32 values of ranks 4d ..
// 4d + 3 of the step's item `it`. fp32 and bf16 items are summed from
// their landing slot (bf16 widened there, as __bfloat162float); int8
// items are widened and scaled by the block into an fp32 slot first
// (kWiden), as score_tile_kernel scales them, since an int8 conversion
// costs more than the 8 FMAs that would share it.
template <typename T>
struct TileIn;
template <>
struct TileIn<float> {
  static constexpr int kRB = 8, kRaw = 32;
  static constexpr bool kWiden = false;
  __device__ __forceinline__ static float4 quad(const unsigned char* slot, int it, int d) {
    return *reinterpret_cast<const float4*>(slot + it * 32 + d * 16);
  }
};
template <>
struct TileIn<__nv_bfloat16> {
  static constexpr int kRB = 16, kRaw = 32;
  static constexpr bool kWiden = false;
  __device__ __forceinline__ static float4 quad(const unsigned char* slot, int it, int d) {
    const uint2 w = *reinterpret_cast<const uint2*>(slot + it * 32 + d * 8);
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  }
};
template <>
struct TileIn<int8_t> {
  static constexpr int kRB = 8, kRaw = 8;
  static constexpr bool kWiden = true;
  __device__ __forceinline__ static float4 quad(const unsigned char* slot, int it, int d) {
    return *reinterpret_cast<const float4*>(slot + it * 32 + d * 16);
  }
  __device__ __forceinline__ static float4 widen(unsigned w) {
    return make_float4(static_cast<float>(static_cast<int8_t>(w & 255u)),
                       static_cast<float>(static_cast<int8_t>((w >> 8) & 255u)),
                       static_cast<float>(static_cast<int8_t>((w >> 16) & 255u)),
                       static_cast<float>(static_cast<int8_t>(w >> 24)));
  }
};

// The rank-count select of a few candidates (count <= 32 * E): each lane
// holds E of them (candidate i = lane + 32 e), counts those before each
// by (key desc, position asc), and the kc with rank < kc are written in
// candidate order (item order) as value/id pairs.
template <int E>
__device__ __forceinline__ void rank_select(const unsigned* ck, const unsigned* cp, int count,
                                            int kc, unsigned* out, long long pairs, unsigned lo) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned key[E], rank[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + 32 * e;
    key[e] = i < count ? ck[i] : 0u;
    rank[e] = 0u;
  }
  for (int j = 0; j < count; ++j) {
    const unsigned kj = ck[j];
#pragma unroll
    for (int e = 0; e < E; ++e)
      rank[e] += (kj > key[e] || (kj == key[e] && j < lane + 32 * e)) ? 1u : 0u;
  }
  unsigned won = 0u;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + 32 * e;
    const bool win = i < count && rank[e] < static_cast<unsigned>(kc);
    const unsigned wins = __ballot_sync(full, win);
    if (win) {
      const unsigned slot = won + __popc(wins & below);
      out[slot] = __float_as_uint(key_float(key[e]));
      out[pairs + slot] = lo + cp[i];
    }
    won += __popc(wins);
  }
}

// The tiled route, block (c, t): chunk c (items [c * TILE_CHUNK, + n),
// n <= TILE_CHUNK) of the TILE_Q queries of tile t, scored and selected
// without leaving the block.
//
// Scoring: each score is score_tile_kernel's, bit for bit: one fmaf chain
// over r from 0 (zeros past R only add +0), bf16 rows widened, int8 rows
// scaled before their FMAs. A step stages a half of the chunk at kRB
// ranks and the tile's queries at those ranks by cp.async, issued one
// step ahead, so loads take no registers and each row's piece is one
// whole sector; one barrier a step (two with int8's widening). The
// first half's rank blocks all come before the second half's, so a
// thread holds TILE_QT x TILE_J / 2 accumulators at a time (no spills
// at the 128 registers of two blocks an SM), and reads 12 float4s of
// shared memory for every 128 FMAs. At the end of a half each score
// becomes its key (float_key; -inf's key for padding rows, row_valid <=
// 0 and the seen bits staged from the bitmap) in the query's row of
// keys, and each thread keeps the top 16 bits of the largest key of its
// 4 items of the half (0 where none lies in the chunk): TILE_GROUPS
// maxima a query.
//
// Selection, warp w for queries w and w + TILE_WARPS, each on its own:
// lane l holds the maxima l + 32 e. For kc = min(k, n) <= 32, t is the
// kc-th largest of the lanes' largest maxima (a rank count over the
// lanes); above, the largest 16-bit t with at least kc maxima >= t (a
// bitwise search, one warp-wide sum a bit). Either way kc distinct
// groups hold a key >= t << 16, so the row's kc winners are among its
// keys >= t << 16. The warp compacts those, in item order; up to 64 of them
// it ranks by counting (rank_select), more by a radix select
// (warp_radix_select; over the whole row if more than TILE_CAND), which
// gives T and `need`: the winners are the keys > T and the first `need`
// keys == T in item order. They are written in item order to candidate
// slots [c * k, c * k + kc) as select_chunk_kernel writes them, and the
// merge is the chunked route's.
template <typename T, bool Vec>
__global__ void __launch_bounds__(TILE_THREADS, 2)
score_select_tile_kernel(const float* __restrict__ Q, const T* __restrict__ Y,
                         const float* __restrict__ scale, const float* __restrict__ row_valid,
                         const unsigned* __restrict__ seen_bits, int W, int B, int M, int R,
                         int n_items, int k, unsigned* __restrict__ cand, long long pairs) {
  using In = TileIn<T>;
  constexpr int RB = In::kRB, NQ = RB / 4;
  constexpr int PIECE = In::kRaw >= 16 ? 16 : In::kRaw;         // bytes a cp.async
  constexpr int PIECES = TILE_HALF * In::kRaw / PIECE / TILE_THREADS;  // a thread's a step
  constexpr int LANES = In::kRaw / PIECE;                        // lanes a row
  extern __shared__ __align__(16) unsigned char tile_smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(tile_smem + TILE_KEYS_OFF);
  unsigned short* gmax = reinterpret_cast<unsigned short*>(tile_smem + TILE_GMAX_OFF);
  unsigned* seen = reinterpret_cast<unsigned*>(tile_smem + TILE_SEEN_OFF);
  float4* qs = reinterpret_cast<float4*>(tile_smem + TILE_QS_OFF);
  unsigned char* stage = tile_smem + TILE_STAGE_OFF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = tid & 1, ig = tid >> 1;  // queries TILE_QT qg ..; items ig + TILE_IG * j
  const int c = blockIdx.x;
  const int lo = c * TILE_CHUNK;
  const int n = min(TILE_CHUNK, M - lo);
  const int b0 = blockIdx.y * TILE_Q;

  for (int e = tid; e < TILE_Q * TILE_WORDS; e += TILE_THREADS) {
    const int q = e / TILE_WORDS, w = lo / 32 + e % TILE_WORDS;
    seen[q * TILE_SEEN_ROW + e % TILE_WORDS] =
        (seen_bits != nullptr && b0 + q < B && w < W)
            ? seen_bits[static_cast<long long>(b0 + q) * W + w]
            : 0u;
  }

  // step s: half s / blocks of the chunk's items (TILE_HALF of them),
  // rank block s % blocks (ranks RB (s % blocks) ..); it lands in slot
  // s & 1 and is summed from sum_slot(s) (int8: the fp32 slot it is
  // widened into). A thread's items of a half are done before the next
  // half begins, so only its TILE_J / 2 accumulators of the half live.
  const int blocks = (R + RB - 1) / RB;
  const int steps = 2 * blocks;
  auto land_slot = [&](int s) {
    return stage + (In::kWiden ? TILE_SLOT : 0) + (s & 1) * TILE_HALF * In::kRaw;
  };
  auto sum_slot = [&](int s) { return In::kWiden ? stage : land_slot(s); };
  // this thread's pieces: piece e = tid + TILE_THREADS u is bytes
  // [PIECE (e % LANES), + PIECE) of the step's item e / LANES
  const long long row_step = static_cast<long long>(TILE_THREADS / LANES) * R;
  const T* row0 = Y + static_cast<long long>(lo + tid / LANES) * R +
                  (tid % LANES) * PIECE / static_cast<int>(sizeof(T));
  // the tile's queries of a rank block: value tid (TILE_Q x RB of them)
  const int qq = tid / RB, qr = tid % RB;
  const float* qrow = Q + static_cast<long long>(b0 + qq) * R + qr;
  const bool q_ok = tid < TILE_Q * RB && b0 + qq < B;
  float* q_dst = reinterpret_cast<float*>(qs + (qr / 4) * TILE_Q + qq) + qr % 4;
  // each piece one aligned cp.async (Vec), else value by value (rows of
  // other widths)
  auto issue = [&](int s) {
    const int h = s >= blocks, r0 = (s - h * blocks) * RB, half = h * TILE_HALF;
    unsigned char* dst = land_slot(s);
#pragma unroll 1
    for (int u = 0; u < PIECES; ++u) {
      const int e = tid + u * TILE_THREADS, it = e / LANES;
      const bool ok = half + it < n;
      if constexpr (Vec) {
        const int off = (e % LANES) * PIECE / static_cast<int>(sizeof(T));
        const bool in = ok && r0 + off < R;
        cp_async<PIECE>(dst + e * PIECE,
                        in ? row0 + static_cast<long long>(half) * R + u * row_step + r0 : Y,
                        in ? PIECE : 0);
      } else {
        constexpr int V = PIECE / static_cast<int>(sizeof(T));
        const int off = (e % LANES) * V;
#pragma unroll
        for (int r = 0; r < V; ++r) {
          const bool in = ok && r0 + off + r < R;
          const T v = in ? Y[static_cast<long long>(lo + half + it) * R + r0 + off + r]
                         : zero_of<T>();
          reinterpret_cast<T*>(dst + e * PIECE)[r] = v;
        }
      }
    }
    if (tid < TILE_Q * RB) {
      const bool ok = q_ok && r0 + qr < R;
      cp_async<4>(q_dst + (s & 1) * TILE_Q * RB, ok ? qrow + r0 : Q, ok ? 4 : 0);
    }
  };

  float acc[TILE_QT][TILE_J / 2];
#pragma unroll
  for (int i = 0; i < TILE_QT; ++i)
#pragma unroll
    for (int j = 0; j < TILE_J / 2; ++j) acc[i][j] = 0.f;
  issue(0);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s has landed everywhere, and step s - 1 is summed
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    const int h = s >= blocks;
    if constexpr (In::kWiden) {
      const int half = h * TILE_HALF;
#pragma unroll
      for (int u = 0; u < TILE_HALF * 2 / TILE_THREADS; ++u) {  // 4 ranks an entry
        const int e = tid + u * TILE_THREADS, it = e >> 1, d = e & 1;
        float4 v = In::widen(*reinterpret_cast<const unsigned*>(land_slot(s) + it * 8 + d * 4));
        if (scale != nullptr) {
          const float sc = half + it < n ? __ldg(scale + lo + half + it) : 1.f;
          v.x *= sc;
          v.y *= sc;
          v.z *= sc;
          v.w *= sc;
        }
        *reinterpret_cast<float4*>(stage + it * 32 + d * 16) = v;
      }
      __syncthreads();
    }
    const unsigned char* slot = sum_slot(s);
    const float4* q4 = qs + (s & 1) * TILE_Q * NQ + TILE_QT * qg;
#pragma unroll
    for (int d = 0; d < NQ; ++d) {
      float4 y[TILE_J / 2];
#pragma unroll
      for (int jj = 0; jj < TILE_J / 2; ++jj) y[jj] = In::quad(slot, ig + TILE_IG * jj, d);
#pragma unroll
      for (int i = 0; i < TILE_QT; ++i) {
        const float4 qv = q4[d * TILE_Q + i];
#pragma unroll
        for (int jj = 0; jj < TILE_J / 2; ++jj) {
          acc[i][jj] = fmaf(y[jj].x, qv.x, acc[i][jj]);
          acc[i][jj] = fmaf(y[jj].y, qv.y, acc[i][jj]);
          acc[i][jj] = fmaf(y[jj].z, qv.z, acc[i][jj]);
          acc[i][jj] = fmaf(y[jj].w, qv.w, acc[i][jj]);
        }
      }
    }
    if (s == h * blocks + blocks - 1) {  // the half's scores are whole: keys and maxima
      unsigned valid = 0u;  // bit jj: item jj of the half lies in the chunk and is a real row
#pragma unroll
      for (int jj = 0; jj < TILE_J / 2; ++jj) {
        const int it = h * TILE_HALF + ig + TILE_IG * jj, m = lo + it;
        if (it < n && m < n_items && (row_valid == nullptr || __ldg(row_valid + m) > 0.f))
          valid |= 1u << jj;
      }
#pragma unroll
      for (int i = 0; i < TILE_QT; ++i) {
        const int q = TILE_QT * qg + i;
        unsigned* row = keys + q * TILE_ROW;
        const unsigned* sq = seen + q * TILE_SEEN_ROW;
        unsigned mx = 0u;
#pragma unroll
        for (int jj = 0; jj < TILE_J / 2; ++jj) {
          const int it = h * TILE_HALF + ig + TILE_IG * jj;
          if (it < n) {
            const bool ok = ((valid >> jj) & 1u) && !((sq[it >> 5] >> (it & 31)) & 1u);
            const unsigned key = float_key(ok ? acc[i][jj] : neg_inf());
            row[it] = key;
            mx = max(mx, key);
          }
          acc[i][jj] = 0.f;
        }
        gmax[q * TILE_GROUPS + ig * 2 + h] = static_cast<unsigned short>(mx >> 16);
      }
    }
  }
  __syncthreads();  // every key is in, and the staging region is free

  unsigned* hist = reinterpret_cast<unsigned*>(stage) + warp * 256;
  unsigned* ck = reinterpret_cast<unsigned*>(stage) + TILE_WARPS * 256 + warp * 2 * TILE_CAND;
  unsigned* cp = ck + TILE_CAND;
  const int kc = min(k, n);
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1u;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int q = warp + h * TILE_WARPS;
    if (b0 + q >= B) break;
    unsigned g[TILE_GROUPS / 32], lmax = 0u;
#pragma unroll
    for (int e = 0; e < TILE_GROUPS / 32; ++e) {
      g[e] = gmax[q * TILE_GROUPS + lane + 32 * e];
      lmax = max(lmax, g[e]);
    }
    unsigned t = 0u;
    if (kc <= 32) {
      // the kc-th largest of the lanes' largest maxima: kc lanes hold a
      // maximum >= it (a rank count over the lanes)
      unsigned above = 0u;
#pragma unroll
      for (int o = 0; o < 32; ++o) above += __shfl_sync(full, lmax, o) > lmax ? 1u : 0u;
      t = __reduce_min_sync(full, above < static_cast<unsigned>(kc) ? lmax : 0xffffu);
    } else {
#pragma unroll 1
      for (int bit = 15; bit >= 0; --bit) {
        const unsigned tc = t | (1u << bit);
        unsigned cnt = 0u;
#pragma unroll
        for (int e = 0; e < TILE_GROUPS / 32; ++e) cnt += g[e] >= tc ? 1u : 0u;
        if (__reduce_add_sync(full, cnt) >= static_cast<unsigned>(kc)) t = tc;
      }
    }
    const unsigned tau = t << 16;
    const unsigned* row = keys + q * TILE_ROW;
    unsigned count = 0u;
    for (int base = 0; base < n; base += 128) {
      unsigned key[4];
      bool take[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + 32 * u + lane;
        key[u] = i < n ? row[i] : 0u;
        take[u] = i < n && key[u] >= tau;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned taken = __ballot_sync(full, take[u]);
        const unsigned slot = count + __popc(taken & below);
        if (take[u] && slot < TILE_CAND) {
          ck[slot] = key[u];
          cp[slot] = static_cast<unsigned>(base + 32 * u + lane);
        }
        count += __popc(taken);
      }
    }
    __syncwarp();
    unsigned* out =
        cand + static_cast<long long>(b0 + q) * 2 * pairs + static_cast<long long>(c) * k;
    if (count <= 32u) {
      rank_select<1>(ck, cp, static_cast<int>(count), kc, out, pairs, static_cast<unsigned>(lo));
    } else if (count <= 64u) {
      rank_select<2>(ck, cp, static_cast<int>(count), kc, out, pairs, static_cast<unsigned>(lo));
    } else {
      const bool fits = count <= static_cast<unsigned>(TILE_CAND);
      const unsigned* arr = fits ? ck : row;
      const int len = fits ? static_cast<int>(count) : n;
      unsigned need, eq;
      const unsigned thr =
          warp_radix_select(arr, len, static_cast<unsigned>(kc), 4, hist, &need, &eq);
      unsigned won = 0u, ties = 0u;
      for (int base = 0; base < len; base += 32) {
        const int i = base + lane;
        const unsigned key = i < len ? arr[i] : 0u;
        const bool tie = i < len && key == thr;
        const unsigned tied = __ballot_sync(full, tie);
        const bool win = i < len && (key > thr || (tie && ties + __popc(tied & below) < need));
        const unsigned wins = __ballot_sync(full, win);
        if (win) {
          const unsigned slot = won + __popc(wins & below);
          out[slot] = __float_as_uint(key_float(key));
          out[pairs + slot] =
              static_cast<unsigned>(lo) + (fits ? cp[i] : static_cast<unsigned>(i));
        }
        won += __popc(wins);
        ties += __popc(tied);
      }
    }
    __syncwarp();  // the next query's compaction overwrites the candidates
  }
}

// The radix_row route, one block per query: the whole row's key/id pairs,
// in id order, stably radix-sorted by key, descending, in two ping-pong
// buffers of gscratch (4 * M words per query); the first k are the result.
__global__ void __launch_bounds__(RADIX_THREADS)
sort_row_kernel(const float* __restrict__ S, int M, int k, unsigned* gscratch,
                float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ RadixSmem sm;
  const long long b = blockIdx.x;
  const float* row = S + b * M;
  unsigned* k0 = gscratch + b * 4 * M;
  unsigned *i0 = k0 + M, *k1 = k0 + 2 * M, *i1 = k0 + 3 * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    k0[i] = float_key(row[i]);
    i0[i] = static_cast<unsigned>(i);
  }
  __syncthreads();
  radix_sort_desc(M, k0, i0, k1, i1, sm);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    vals[b * k + j] = key_float(~k0[j]);
    idx[b * k + j] = static_cast<int>(i0[j]);
  }
}

// The whole-row route by a cluster of SORT_CLUSTER blocks, one cluster
// per query: block r holds the share [r * share, r * share + share) of
// the row's pairs in two ping-pong buffers in its shared memory. Each of
// the four passes counts its digits, reads every block's counts through
// distributed shared memory (a pair of digit d in block r goes after all
// pairs of smaller digits and after those of digit d in blocks 0..r-1,
// so the sort stays stable), and scatter_pass writes each pair into the
// block that owns its slot. The first k slots are the result.
__global__ void __cluster_dims__(SORT_CLUSTER, 1, 1) __launch_bounds__(RADIX_THREADS)
sort_row_cluster_kernel(const float* __restrict__ S, int M, int k, float* __restrict__ vals,
                        int* __restrict__ idx) {
  extern __shared__ unsigned dyn[];
  __shared__ RadixSmem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  const int r = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / SORT_CLUSTER;
  const float* row = S + b * M;
  const int share = (M + SORT_CLUSTER - 1) / SORT_CLUSTER;
  const int lo = r * share, n = max(0, min(M, lo + share) - lo);
  unsigned *k0 = dyn, *i0 = dyn + share, *k1 = dyn + 2 * share, *i1 = dyn + 3 * share;
  for (int i = tid; i < n; i += blockDim.x) {  // inverted keys: ascending = descending scores
    k0[i] = ~float_key(row[lo + i]);
    i0[i] = static_cast<unsigned>(lo + i);
  }
  for (int e = tid; e < RADIX_WARPS * 256; e += blockDim.x) (&sm.wofs[0][0])[e] = 0;

  for (int p = 0; p < 4; ++p) {
    const int shift = 8 * p;
    for (int e = tid; e < 256; e += blockDim.x) sm.hist[0][e] = 0u;
    __syncthreads();
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + tid;
      const int d = i < n ? static_cast<int>((k0[i] >> shift) & 255u) : -1;
      const unsigned peers = digit_peers(d);
      if (d >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&sm.hist[0][d], static_cast<unsigned>(__popc(peers)));
    }
    cluster.sync();  // every block's counts are in
    if (tid < 32) {  // digits lane * 8 ..: their bases in the row, then this block's
      unsigned tot[8], before[8], s = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tot[j] = before[j] = 0u;
        for (int rr = 0; rr < SORT_CLUSTER; ++rr) {
          const unsigned c = cluster.map_shared_rank(&sm.hist[0][0], rr)[lane * 8 + j];
          tot[j] += c;
          if (rr < r) before[j] += c;
        }
        s += tot[j];
      }
      unsigned inc = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      unsigned run = inc - s;
      bool whole = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sm.dbase[lane * 8 + j] = run + before[j];
        run += tot[j];
        whole |= tot[j] == static_cast<unsigned>(M);
      }
      whole = __any_sync(0xffffffffu, whole);
      if (lane == 0) sm.skip[p] = whole;
    }
    __syncthreads();
    if (!sm.skip[p]) {  // the same in every block: a digit shared by the whole row
      scatter_pass(n, k0, i0, shift, sm, [&](unsigned pos, unsigned key, unsigned id) {
        const int owner = static_cast<int>(pos) / share;
        const unsigned off = pos - static_cast<unsigned>(owner * share);
        cluster.map_shared_rank(k1, owner)[off] = key;
        cluster.map_shared_rank(i1, owner)[off] = id;
      });
    }
    cluster.sync();  // every pair has landed; the counts may be cleared
    if (!sm.skip[p]) {
      unsigned* t = k0;
      k0 = k1;
      k1 = t;
      t = i0;
      i0 = i1;
      i1 = t;
    }
  }
  for (int i = tid; i < n && lo + i < k; i += blockDim.x) {
    vals[b * k + lo + i] = key_float(~k0[i]);
    idx[b * k + lo + i] = static_cast<int>(i0[i]);
  }
}

// Widest row sort_row_cluster_kernel holds on each device: two ping-pong
// buffers of a share of ceil(M / SORT_CLUSTER) pairs per block.
int g_cluster_max_row[MAX_DEVICES];

// The tiled route's first steps on stream s: the seen bitmap (zeroed,
// then seen_bits_kernel) when the mask is on, then
// score_select_tile_kernel over (chunks x query tiles) into the
// candidate rows.
cudaError_t launch_tiled(const float* Q, int B, int R, const void* Y, int y_dtype,
                         const float* scale, const float* row_valid, int M, int n_items,
                         const int* seen_cols, const float* seen_mask, int L, long long col_sl,
                         long long col_sb, long long mask_sl, long long mask_sb, int mask_seen,
                         int k, int chunks, unsigned* bits, unsigned* cand, long long pairs,
                         cudaStream_t s) {
  const int W = (M + 31) / 32;
  const unsigned* seen_bits = nullptr;
  if (mask_seen && L > 0) {
    if (bits == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(bits, 0, static_cast<size_t>(B) * W * sizeof(unsigned), s);
    if (err != cudaSuccess) return err;
    const long long n = static_cast<long long>(L) * B;
    seen_bits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        seen_cols, seen_mask, col_sl, col_sb, mask_sl, mask_sb, L, B, bits, W, M);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    seen_bits = bits;
  }
  // each piece of a step one aligned cp.async: 4 fp32 or 8 bf16 values
  // (16 bytes), 8 int8 values (8 bytes)
  const uintptr_t y = reinterpret_cast<uintptr_t>(Y);
  const bool vec = y_dtype == 0   ? R % 4 == 0 && y % 16 == 0
                   : y_dtype == 1 ? R % 8 == 0 && y % 16 == 0
                                  : R % 8 == 0 && y % 8 == 0;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>((B + TILE_Q - 1) / TILE_Q));
  auto go = [&](auto kernel, const auto* Yt) {
    kernel<<<grid, TILE_THREADS, TILE_SMEM, s>>>(Q, Yt, scale, row_valid, seen_bits, W, B, M, R,
                                                 n_items, k, cand, pairs);
  };
  switch (y_dtype) {
    case 0: {
      const float* Yt = static_cast<const float*>(Y);
      vec ? go(score_select_tile_kernel<float, true>, Yt)
          : go(score_select_tile_kernel<float, false>, Yt);
      break;
    }
    case 1: {
      const __nv_bfloat16* Yt = static_cast<const __nv_bfloat16*>(Y);
      vec ? go(score_select_tile_kernel<__nv_bfloat16, true>, Yt)
          : go(score_select_tile_kernel<__nv_bfloat16, false>, Yt);
      break;
    }
    case 2: {
      const int8_t* Yt = static_cast<const int8_t*>(Y);
      vec ? go(score_select_tile_kernel<int8_t, true>, Yt)
          : go(score_select_tile_kernel<int8_t, false>, Yt);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once per device, before its first pio_fused_topk: lets the cluster
// sort take all the dynamic shared memory a block may opt into. Returns
// the CUDA error code.
int pio_fused_topk_init(int device) {
  if (device < 0 || device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, sort_row_cluster_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(sort_row_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int share = dyn / static_cast<int>(4 * sizeof(unsigned));
  // the tiled route: its shared memory, two blocks an SM
  const void* tiled[] = {
      reinterpret_cast<const void*>(score_select_tile_kernel<float, true>),
      reinterpret_cast<const void*>(score_select_tile_kernel<__nv_bfloat16, true>),
      reinterpret_cast<const void*>(score_select_tile_kernel<int8_t, true>),
      reinterpret_cast<const void*>(score_select_tile_kernel<float, false>),
      reinterpret_cast<const void*>(score_select_tile_kernel<__nv_bfloat16, false>),
      reinterpret_cast<const void*>(score_select_tile_kernel<int8_t, false>)};
  for (const void* fn : tiled) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(TILE_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  g_cluster_max_row[device] = SORT_CLUSTER * share;
  return 0;
}

// The widest row (items) the cluster sort takes on `device`, which
// pio_fused_topk_init has set up; a wider one takes the radix_row route.
int pio_topk_cluster_max_row(int device) {
  if (device < 0 || device >= MAX_DEVICES) return 0;
  return g_cluster_max_row[device];
}

// y_dtype: 0 = fp32, 1 = bf16, 2 = int8 (scale required). scale and
// row_valid may be null. seen_cols / seen_mask are [L, B] with the given
// element strides. route is the host's sort route (ROUTE_*): cluster_row
// takes rows up to pio_topk_cluster_max_row(device) items; radix_row
// needs sort_scratch of scratch_pairs >= 2 * M uint32 key/id pairs per
// query; chunked (k <= CHUNK_K_MAX) cuts the row into chunks of
// TOPK_CHUNK items and needs sort_scratch of scratch_pairs >= (chunks -
// 1) * k + min(k, last chunk) value/id pairs per query; tiled (k <=
// CHUNK_K_MAX) the same with chunks of TILE_CHUNK items (sort_scratch may
// be null on the other routes). scores is a [B, M] fp32 scratch, except
// on the tiled route: there a [B, ceil(M / 32)] uint32 scratch for the
// seen bitmap (unused with the mask off). Launches
// on `stream` of CUDA device `device`, which pio_fused_topk_init has set
// up; returns cudaGetLastError(). ev_start / ev_end, when not null, are
// CUDA events recorded on `stream` just before the first kernel and just
// after the last, so their elapsed time is the kernels' own (the caller's
// timing; no synchronisation here).
int pio_fused_topk(int device, const float* Q, int B, int R, const void* Y, int y_dtype,
                   const float* scale, const float* row_valid, int M, int n_items,
                   const int* seen_cols, const float* seen_mask, int L,
                   long long col_sl, long long col_sb, long long mask_sl,
                   long long mask_sb, int mask_seen, int k, int route,
                   float* scores, unsigned* sort_scratch, long long scratch_pairs,
                   float* vals, int* idx, void* stream, void* ev_start, void* ev_end) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0 || R <= 0 || k <= 0 || k > M || (y_dtype == 2 && scale == nullptr) ||
      device < 0 || device >= MAX_DEVICES || g_cluster_max_row[device] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const int N = next_pow2(k);  // the bitonic sort's width
  int chunks = 0, cands = 0;
  if (route == ROUTE_CHUNKED || route == ROUTE_TILED) {
    if (k > CHUNK_K_MAX || sort_scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int width = route == ROUTE_TILED ? TILE_CHUNK : TOPK_CHUNK;
    chunks = (M + width - 1) / width;
    cands = (chunks - 1) * k + std::min(k, M - (chunks - 1) * width);
    if (scratch_pairs < cands) return static_cast<int>(cudaErrorInvalidValue);
    smem = 2 * static_cast<size_t>(N) * sizeof(unsigned);
  } else if (route == ROUTE_BITONIC) {
    smem = 2 * static_cast<size_t>(N) * sizeof(unsigned);
  } else if (route == ROUTE_CLUSTER_ROW) {
    if (M > g_cluster_max_row[device]) return static_cast<int>(cudaErrorInvalidValue);
    smem = 4 * static_cast<size_t>((M + SORT_CLUSTER - 1) / SORT_CLUSTER) * sizeof(unsigned);
  } else if (route != ROUTE_RADIX_ROW || sort_scratch == nullptr || scratch_pairs < 2LL * M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ev_start != nullptr) {
    err = cudaEventRecord(static_cast<cudaEvent_t>(ev_start), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  if (route == ROUTE_TILED) {
    err = launch_tiled(Q, B, R, Y, y_dtype, scale, row_valid, M, n_items, seen_cols, seen_mask,
                       L, col_sl, col_sb, mask_sl, mask_sb, mask_seen, k, chunks,
                       reinterpret_cast<unsigned*>(scores), sort_scratch, scratch_pairs, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    select_bitonic_kernel<<<B, SELECT_THREADS, smem, s>>>(
        reinterpret_cast<const float*>(sort_scratch), 2 * scratch_pairs, cands, k, N,
        reinterpret_cast<const int*>(sort_scratch + scratch_pairs), vals, idx);
    err = cudaGetLastError();
    if (err == cudaSuccess && ev_end != nullptr)
      err = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), s);
    return static_cast<int>(err);
  }

  const dim3 grid1((M + TM - 1) / TM, (B + TB - 1) / TB);
  switch (y_dtype) {
    case 0:
      score_tile_kernel<float><<<grid1, SCORE_THREADS, 0, s>>>(
          Q, static_cast<const float*>(Y), scale, row_valid, scores, B, M, R, n_items);
      break;
    case 1:
      score_tile_kernel<__nv_bfloat16><<<grid1, SCORE_THREADS, 0, s>>>(
          Q, static_cast<const __nv_bfloat16*>(Y), scale, row_valid, scores, B, M, R,
          n_items);
      break;
    case 2:
      score_tile_kernel<int8_t><<<grid1, SCORE_THREADS, 0, s>>>(
          Q, static_cast<const int8_t*>(Y), scale, row_valid, scores, B, M, R, n_items);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (mask_seen && L > 0) {
    const long long n = static_cast<long long>(L) * B;
    seen_mask_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        seen_cols, seen_mask, col_sl, col_sb, mask_sl, mask_sb, L, B, scores, M);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  if (route == ROUTE_CHUNKED) {
    select_chunk_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * chunks),
                          CHUNK_THREADS, 0, s>>>(scores, M, k, chunks, sort_scratch,
                                                 scratch_pairs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    select_bitonic_kernel<<<B, SELECT_THREADS, smem, s>>>(
        reinterpret_cast<const float*>(sort_scratch), 2 * scratch_pairs, cands, k, N,
        reinterpret_cast<const int*>(sort_scratch + scratch_pairs), vals, idx);
  } else if (route == ROUTE_BITONIC) {
    select_bitonic_kernel<<<B, SELECT_THREADS, smem, s>>>(scores, M, M, k, N, nullptr, vals,
                                                          idx);
  } else if (route == ROUTE_CLUSTER_ROW) {
    sort_row_cluster_kernel<<<B * SORT_CLUSTER, RADIX_THREADS, smem, s>>>(scores, M, k, vals,
                                                                        idx);
  } else {
    sort_row_kernel<<<B, RADIX_THREADS, 0, s>>>(scores, M, k, sort_scratch, vals, idx);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess && ev_end != nullptr)
    err = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), s);
  return static_cast<int>(err);
}

}  // extern "C"
