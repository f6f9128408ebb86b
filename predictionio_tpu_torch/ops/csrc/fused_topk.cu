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
// in no order, so the work is split in two passes:
//
//   1. score_tile_kernel: one block per (64 items x 16 queries) tile
//      computes the scores with fp32 FMAs (no tensor cores, no TF32:
//      the reference pins Precision.HIGHEST), widening bf16 and scaling
//      int8 rows as they are loaded, masks padding and invalid rows, and
//      writes the [B, M] score matrix. seen_mask_kernel then scatters
//      -inf into each query's seen ids: O(L*B) work, where the TPU kernel
//      compared every tile against all L seen slots.
//   2. select_sort_kernel: one block per query finds the k-th largest
//      score by an MSB-first radix select over order-preserving 32-bit
//      keys (a second select over ids resolves ties at the threshold to
//      the lowest ids), gathers the k winners, and sorts them by
//      (score desc, id asc) with a bitonic network, in shared memory
//      when the padded width fits and in a global scratch otherwise, so
//      any k up to M works.
//
// Bound on this card: the item table is read once (M*R*bytes(dtype)) and
// the product is 2*B*M*R fp32 FMAs at the non-tensor fp32 rate; at B=1 the
// bytes bound it, at B=256 the operations do. The [B, M] score matrix
// makes one round trip through device memory (about 27 MB at B=256,
// M=26,744), which the TPU design avoided; keeping scores on chip is the
// first thing a faster version removes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;          // items per score tile
constexpr int TB = 16;          // queries per score tile
constexpr int RC = 32;          // rank chunk held in shared memory
constexpr int SCORE_THREADS = 256;
constexpr int SELECT_THREADS = 1024;
constexpr int SMEM_SORT_MAX = 16384;  // widest sort kept in shared memory

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

// Block-wide MSB-first radix select. Returns the key T of the element of
// descending rank `rank` (1-based). With by_id false the keys are the
// scores' keys over the whole row; with by_id true the candidates are the
// elements whose score key equals `tie_key` and their key is ~id, so the
// select counts ids in ascending order. *need receives rank minus the
// number of candidates with key > T; *eq the number with key == T.
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
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned cum = 0u;
      int sel = 0;
      for (int d = 255; d >= 0; --d) {
        const unsigned h = hist[d];
        if (cum + h >= remaining) {
          sel = d;
          break;
        }
        cum += h;
      }
      sh[0] = static_cast<unsigned>(sel);
      sh[1] = remaining - cum;
      sh[2] = hist[sel];
    }
    __syncthreads();
    prefix |= sh[0] << shift;
    pmask |= 255u << shift;
    remaining = sh[1];
    eq_count = sh[2];
  }
  *need = remaining;
  *eq = eq_count;
  return prefix;
}

// (key desc, id asc): does (ka, ia) come before (kb, ib)?
__device__ __forceinline__ bool before(unsigned ka, unsigned ia, unsigned kb, unsigned ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__global__ void __launch_bounds__(SELECT_THREADS)
select_sort_kernel(const float* __restrict__ S, int M, int k, int N,
                   unsigned* gscratch, float* __restrict__ vals,
                   int* __restrict__ idx) {
  extern __shared__ unsigned dyn[];
  __shared__ unsigned hist[256];
  __shared__ unsigned sh[4];
  const long long b = blockIdx.x;
  const float* row = S + b * M;
  unsigned* skey = gscratch != nullptr ? gscratch + b * 2 * N : dyn;
  unsigned* sid = skey + N;

  unsigned need, eq;
  const unsigned T = radix_select(row, M, static_cast<unsigned>(k), false, 0u, hist, sh,
                                  &need, &eq);
  // the k winners: every key above T, and the `need` lowest ids at T
  unsigned id_cut = 0xffffffffu;
  if (need < eq) {
    unsigned need2, eq2;
    id_cut = ~radix_select(row, M, need, true, T, hist, sh, &need2, &eq2);
  }
  if (threadIdx.x == 0) sh[3] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const unsigned key = float_key(row[i]);
    if (key > T || (key == T && static_cast<unsigned>(i) <= id_cut)) {
      const unsigned slot = atomicAdd(&sh[3], 1u);
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
      for (int t = threadIdx.x; t < N / 2; t += blockDim.x) {
        const int lo = (t / stride) * 2 * stride + (t % stride);
        const int hi = lo + stride;
        const unsigned ka = skey[lo], ia = sid[lo], kb = skey[hi], ib = sid[hi];
        const bool up = (lo & size) == 0;
        const bool swap = up ? before(kb, ib, ka, ia) : before(ka, ia, kb, ib);
        if (swap) {
          skey[lo] = kb;
          sid[lo] = ib;
          skey[hi] = ka;
          sid[hi] = ia;
        }
      }
      __syncthreads();
    }
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    vals[b * k + j] = key_float(skey[j]);
    idx[b * k + j] = static_cast<int>(sid[j]);
  }
}

}  // namespace

extern "C" {

// Largest sort width select_sort_kernel keeps in shared memory; wider
// sorts need a [B, 2*N] uint32 scratch from the caller.
int pio_topk_smem_sort_max() { return SMEM_SORT_MAX; }

const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once per device, before its first pio_fused_topk: lets select_sort_kernel
// take its widest shared-memory sort (2 * SMEM_SORT_MAX keys and ids,
// above the 48 KB default). Returns the CUDA error code.
int pio_fused_topk_init(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      select_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * SMEM_SORT_MAX * static_cast<int>(sizeof(unsigned))));
}

// y_dtype: 0 = fp32, 1 = bf16, 2 = int8 (scale required). scale and
// row_valid may be null. seen_cols / seen_mask are [L, B] with the given
// element strides. N is the sort width: a power of two >= k; sort_scratch
// is null when N <= pio_topk_smem_sort_max(). scores is a [B, M] fp32
// scratch. Launches on `stream` of CUDA device `device`, which
// pio_fused_topk_init has set up; returns cudaGetLastError().
int pio_fused_topk(int device, const float* Q, int B, int R, const void* Y, int y_dtype,
                   const float* scale, const float* row_valid, int M, int n_items,
                   const int* seen_cols, const float* seen_mask, int L,
                   long long col_sl, long long col_sb, long long mask_sl,
                   long long mask_sb, int mask_seen, int k, int N, float* scores,
                   unsigned* sort_scratch, float* vals, int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0 || R <= 0 || k <= 0 || k > M || N < k || (N & (N - 1)) != 0 ||
      (sort_scratch == nullptr && N > SMEM_SORT_MAX) || (y_dtype == 2 && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

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

  const size_t smem = sort_scratch == nullptr ? 2 * static_cast<size_t>(N) * sizeof(unsigned) : 0;
  select_sort_kernel<<<B, SELECT_THREADS, smem, s>>>(scores, M, k, N, sort_scratch, vals,
                                                     idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
