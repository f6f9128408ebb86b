// The two kernels of an ALS half-step, written for Hopper (sm_90a):
//
//   assemble_kernel   replaces predictionio_tpu/ops/als_pallas.py::
//                     assemble_normal_equations (kernel _kernel)
//   spd_solve_kernel  replaces predictionio_tpu/ops/als_pallas.py::spd_solve
//                     (kernel _spd_solve_kernel)
//
// assemble_kernel. For each solve row b with slots l < L it gathers
// y_l = Y[cols[b, l]] and writes
//   A[b] = gram + sum_l aw[b, l] * y_l y_l^T      b[b] = sum_l bw[b, l] * y_l
// in fp32 FMAs (no tensor cores, no TF32: the reference pins
// Precision.HIGHEST). One block owns one row and one 64 x 64 tile of its
// A (one tile at R <= 64); 256 threads hold 4 x 4 of the tile each in
// registers. The block walks the row's slots in chunks of 32, gathers
// the chunk's factor rows into shared memory (coalesced: one row of R
// floats per slot) and folds them into its registers, so nothing
// [B, L, R]-sized ever reaches device memory; that is what the TPU
// kernel's VMEM gather bought. Slots whose two weights are both 0
// (padding) are neither gathered nor summed, and a chunk of padding
// only is skipped whole. Rank is taken as given; the TPU kernel padded
// it to 128 for DMA alignment.
// Bound on this card: slots * (R(R+1) + 2R) fp32 operations at 67
// TFLOP/s (A is symmetric: one FMA per upper-triangle entry per slot)
// against Y read once (it fits in L2), the [B, L] tables and the A/b
// outputs at 3.35 TB/s; at R = 64 the operations bind for all but the
// shortest rows. This kernel computes all R^2 entries, twice the work. A few very long rows (the
// item side under power-law popularity) run as one block each and
// leave a tail; splitting them is later work.
//
// spd_solve_kernel. One block solves one system A x = b, resident in
// shared memory (a row stride of R | 1 keeps row and column walks free
// of bank conflicts; R = 64 is 16.6 KB). Right-looking, non-pivoted
// Cholesky A = U^T U on the upper triangle, with the pivot clamped at
// max(d, 1e-30) as in the TPU kernel, then U^T y = b and U x = y by
// column sweeps. Each product is rounded before its subtraction
// (__fmul_rn / __fsub_rn, no FMA contraction), so the kernel repeats
// the plain PyTorch version's arithmetic operation for operation. The
// TPU kernel's batch-on-lanes layout is a TPU device and is not copied.
// Bound on this card: B * (R(R+1)/2 + 2R) * 4 bytes (the upper triangle
// of A, b and x) at 3.35 TB/s against B * (R^3/3 + 2R^2) fp32
// operations; the bytes bind. This kernel reads all of A. R is limited by
// the block's shared memory (pio_spd_max_rank).

#include <cuda_runtime.h>

namespace {

constexpr int ASM_THREADS = 256;
constexpr int ASM_TILE = 64;   // rows and columns of A per block
constexpr int ASM_CHUNK = 32;  // slots gathered into shared memory at a time
constexpr int SOLVE_THREADS = 128;
constexpr int ASM_SMEM_MAX = 48 * 1024;

__global__ void __launch_bounds__(ASM_THREADS)
assemble_kernel(const float* __restrict__ Y, int M, int R, const int* __restrict__ cols,
                const float* __restrict__ aw, const float* __restrict__ bw, int L,
                const float* __restrict__ gram, float* __restrict__ A,
                float* __restrict__ bvec, int n_tiles) {
  extern __shared__ float smem[];
  float* ys = smem;                 // [ASM_CHUNK][R] gathered factor rows
  float* saw = ys + ASM_CHUNK * R;  // [ASM_CHUNK] A weights of the chunk
  float* sbw = saw + ASM_CHUNK;     // [ASM_CHUNK] b weights of the chunk
  const long long row = blockIdx.x;
  const int i0 = (blockIdx.y / n_tiles) * ASM_TILE;
  const int j0 = (blockIdx.y % n_tiles) * ASM_TILE;
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;  // rows i0+ti+16a, columns j0+tj+16c
  const bool does_b = j0 == 0 && tid < ASM_TILE && i0 + tid < R;
  const int* crow = cols + row * L;
  const float* arow = aw + row * L;
  const float* brow = bw + row * L;
  float acc[4][4] = {};
  float bacc = 0.f;

  for (int l0 = 0; l0 < L; l0 += ASM_CHUNK) {
    const int n = min(ASM_CHUNK, L - l0);
    int live = 0;
    if (tid < ASM_CHUNK) {
      const float a = tid < n ? arow[l0 + tid] : 0.f;
      const float b = tid < n ? brow[l0 + tid] : 0.f;
      saw[tid] = a;
      sbw[tid] = b;
      live = a != 0.f || b != 0.f;
    }
    if (!__syncthreads_or(live)) continue;  // padding only
    for (int e = tid; e < ASM_CHUNK * R; e += ASM_THREADS) {
      const int s = e / R;
      float v = 0.f;
      if (saw[s] != 0.f || sbw[s] != 0.f) {  // so s < n
        const int c = crow[l0 + s];
        if (c >= 0 && c < M) v = Y[static_cast<long long>(c) * R + (e - s * R)];
      }
      ys[e] = v;
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float w = saw[s];
      if (w == 0.f) continue;  // the same s for every thread: no divergence
      const float* y = ys + s * R;
      float yi[4], yj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ti + 16 * a;
        yi[a] = i < R ? w * y[i] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tj + 16 * c;
        yj[c] = j < R ? y[j] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(yi[a], yj[c], acc[a][c]);
    }
    if (does_b)
      for (int s = 0; s < n; ++s) bacc = fmaf(sbw[s], ys[s * R + i0 + tid], bacc);
    __syncthreads();
  }

  float* Arow = A + row * R * R;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ti + 16 * a;
    if (i >= R) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tj + 16 * c;
      if (j < R) Arow[i * R + j] = gram[i * R + j] + acc[a][c];
    }
  }
  if (does_b) bvec[row * R + i0 + tid] = bacc;
}

__host__ __device__ inline int solve_stride(int R) { return R | 1; }

inline size_t solve_smem_bytes(int R) {
  return (static_cast<size_t>(R) * solve_stride(R) + R) * sizeof(float);
}

__global__ void __launch_bounds__(SOLVE_THREADS)
spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                 float* __restrict__ x, int R) {
  extern __shared__ float smem[];
  const int S = solve_stride(R);
  float* a = smem;       // [R][S]; its upper triangle becomes U
  float* v = a + R * S;  // [R]: b, then y, then x
  const long long sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = SOLVE_THREADS / 32;
  const float* Ab = A + sys * R * R;
  for (int e = tid; e < R * R; e += SOLVE_THREADS) {
    const int i = e / R;
    a[i * S + (e - i * R)] = Ab[e];
  }
  for (int i = tid; i < R; i += SOLVE_THREADS) v[i] = b[sys * R + i];
  __syncthreads();

  for (int k = 0; k < R; ++k) {
    const float inv = 1.f / sqrtf(fmaxf(a[k * S + k], 1e-30f));
    __syncthreads();  // every thread has the pivot before row k changes
    for (int j = k + tid; j < R; j += SOLVE_THREADS) a[k * S + j] = __fmul_rn(a[k * S + j], inv);
    __syncthreads();
    // a[i][j] -= u[k][i] * u[k][j] for k < i <= j: one warp per row
    for (int i = k + 1 + warp; i < R; i += n_warps) {
      const float ui = a[k * S + i];
      for (int j = i + lane; j < R; j += 32)
        a[i * S + j] = __fsub_rn(a[i * S + j], __fmul_rn(ui, a[k * S + j]));
    }
    __syncthreads();
  }

  for (int k = 0; k < R; ++k) {  // U^T y = b
    const float yk = v[k] / a[k * S + k];
    __syncthreads();
    if (tid == 0) v[k] = yk;
    for (int j = k + 1 + tid; j < R; j += SOLVE_THREADS)
      v[j] = __fsub_rn(v[j], __fmul_rn(a[k * S + j], yk));
    __syncthreads();
  }
  for (int k = R - 1; k >= 0; --k) {  // U x = y
    const float xk = v[k] / a[k * S + k];
    __syncthreads();
    if (tid == 0) v[k] = xk;
    for (int i = tid; i < k; i += SOLVE_THREADS)
      v[i] = __fsub_rn(v[i], __fmul_rn(a[i * S + k], xk));
    __syncthreads();
  }
  for (int i = tid; i < R; i += SOLVE_THREADS) x[sys * R + i] = v[i];
}

inline size_t assemble_smem_bytes(int R) {
  return (static_cast<size_t>(ASM_CHUNK) * R + 2 * ASM_CHUNK) * sizeof(float);
}

}  // namespace

extern "C" {

const char* pio_als_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest rank assemble_kernel takes: its chunk of factor rows stays
// within the 48 KB of shared memory a block has without opting in.
int pio_assemble_max_rank() {
  int r = 1;
  while (assemble_smem_bytes(r + 1) <= ASM_SMEM_MAX) ++r;
  return r;
}

// Largest rank spd_solve_kernel takes on `device`: the system must fit
// in the shared memory one block may opt into. Negative: a CUDA error.
int pio_spd_max_rank(int device) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int r = 0;
  while (solve_smem_bytes(r + 1) <= static_cast<size_t>(optin)) ++r;
  return r;
}

// Once per device, before its first pio_spd_solve: lets spd_solve_kernel
// take up to `max_rank`'s shared memory (above the 48 KB default).
int pio_als_solve_init(int device, int max_rank) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(spd_solve_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(solve_smem_bytes(max_rank))));
}

// A [B, R, R] and b [B, R] from Y [M, R], cols / aw / bw [B, L] and gram
// [R, R]; all fp32 except cols (int32), contiguous, on `device`. Launches
// on `stream`; returns cudaGetLastError().
int pio_assemble_normal_equations(int device, const float* Y, int M, int R, const int* cols,
                                  const float* aw, const float* bw, int B, int L,
                                  const float* gram, float* A, float* b, void* stream) {
  if (B <= 0 || R <= 0 || R > pio_assemble_max_rank() || L < 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (R + ASM_TILE - 1) / ASM_TILE;
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(n_tiles * n_tiles));
  assemble_kernel<<<grid, ASM_THREADS, assemble_smem_bytes(R),
                    static_cast<cudaStream_t>(stream)>>>(Y, M, R, cols, aw, bw, L, gram, A, b,
                                                         n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// x [B, R] solving A x = b for A [B, R, R] (symmetric positive definite;
// the upper triangle is read) and b [B, R], fp32, contiguous, on
// `device`, which pio_als_solve_init has set up for rank R. Launches on
// `stream`; returns cudaGetLastError().
int pio_spd_solve(int device, const float* A, const float* b, int B, int R, float* x,
                  void* stream) {
  if (B <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  spd_solve_kernel<<<static_cast<unsigned>(B), SOLVE_THREADS, solve_smem_bytes(R),
                     static_cast<cudaStream_t>(stream)>>>(A, b, x, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
