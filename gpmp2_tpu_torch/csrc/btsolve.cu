// K1: batched block-tridiagonal SPD solve x = (H + lam I)^{-1} b on Hopper.
//
// Replaces the TPU kernel gpmp2_tpu/ops/btsolve.py:_bt_kernel (its
// pallas_call at btsolve.py:237). Same math: per problem, symmetric Jacobi
// scaling S = diag(rsqrt(max(diag(D) + lam, 1e-30))) folded in (the
// damped, scaled operands never reach device memory), a forward block
// Cholesky sweep that stores G_i = C_i^{-1} U_i and w_i = C_i^{-1} z_i and
// carries U_i^T [G_i | w_i], then back substitution and the rescale by S.
// A non-positive pivot makes rsqrt return NaN or inf, which spreads through
// that problem's x only, as the JAX kernel's unrolled Cholesky does.
//
// What bounds it on an H100: the serial recurrence. At the main-path shape
// (B = 2048, n = 11, M = 14, f32) the bytes (D, U, b, lam in, x out:
// ~36 MB, ~11 us at the published 3.35 TB/s) and the ~0.2 GFLOP are both
// small; each problem is a chain of n dependent block steps, each a
// Cholesky, a two-sided solve with M + 1 right-hand sides and an
// M x (M + 1) product, so the time is one warp's latency through that
// chain. The first port ran the chain in one thread per problem (64
// one-warp blocks at B = 2048, half the SMs idle), with the working set
// spilled to local memory and loads n * M * M elements apart across the
// warp.
//
// Design: one warp per problem, bt_plan's warps per block.
//   - The working set (the carry and then the factor C, the scaled U_i,
//     the [U_i | z] right-hand side X solved in place, the scales) lives in
//     shared memory, rows padded to M + 1 so that column walks across lanes
//     do not conflict on banks.
//   - Operands move as the warp's contiguous M * M span (lane k takes
//     elements k, k + 32, ...), so every access is coalesced. They arrive
//     by cp.async into a staging area one step ahead: D_{i+1}, U_{i+1},
//     b_{i+1} and diag(D_{i+2}) load while block i is factored, and
//     G_{i-1}, w_{i-1} and diag(D_{i-1}) while back step i runs, so no
//     step waits on device memory.
//   - Each block step is spread over the lanes. The Cholesky is
//     left-looking by columns with one lane per row: each lane's entry is a
//     dot product over the finished columns, which reads only entries no
//     lane writes in that step, so its loads pipeline (a right-looking
//     trailing update stores and reloads the same array in each step and
//     serialises on that); the pivot's inverse is one rsqrt. The forward
//     and back substitutions run one lane per right-hand-side column, with
//     the column held in registers (unrolled over M), so the substitution
//     is a chain of FMAs fed by broadcast reads of L. The carry
//     U_i^T [G_i | w_i] puts lanes over its M (M + 1) outputs; the back
//     substitution x_i = w_i - G_i x_{i+1} runs one lane per row.
//   - G_i goes to the (B, n, M, M) scratch the wrapper allocates, written
//     and read back coalesced (~35 MB at the main shape), so every n fits.
// Tensor cores do not pay here: each product is 14 x 15 on a serial chain
// of dependent block steps, far below a wgmma tile, and the f64 path would
// need the FP64 MMA at the same small shapes.
// M is a template parameter (M in {2, 4, ..., 36}: 36 is the PR2 mobile
// manipulator's 2 * 18 dof); only the substitution is unrolled (O(M^2)
// code), so the 36 instantiations build in seconds, where the first port's
// fully unrolled O(M^3) thread took over a minute.
// bt_plan picks the warps per block: 4, halved while the block's shared
// memory exceeds 48 KB. At M = 36 in f64 one warp alone needs 54.7 KB, so
// that launch opts in to more dynamic shared memory (up to 227 KB per block
// on Hopper). The launch bounds ask for 4 resident blocks per SM, so at
// B = 2048 and M = 14 all 512 blocks are on the card at once.
// What still bounds it: the latency of the n dependent block steps of one
// warp (at B = 1 that is the whole time); at B = 2048 the ~16 warps per SM
// interleave those chains, and at M = 14 only 15 of 32 lanes work in the
// solve.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxM = 36;  // largest block size built: PR2, 2 * 18 dof
constexpr int kMaxWarps = 4;
constexpr int kMinBlocks = 4;  // resident blocks per SM the registers must allow
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
// the pivot's inverse; NaN for a negative pivot, inf for a zero one
__device__ __forceinline__ float dev_rsqrt(float v) { return rsqrtf(v); }
__device__ __forceinline__ double dev_rsqrt(double v) { return rsqrt(v); }

// rsqrt(max(v, 1e-30)) with NaN propagating like jnp.maximum
template <typename T>
__device__ __forceinline__ T jacobi(T diag, T lam) {
  T v = diag + lam;
  v = (v < T(1e-30)) ? T(1e-30) : v;
  return T(1) / dev_sqrt(v);
}

// one element from device memory into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}

// shared-memory elements of one warp: C, Us, X and the staged D or G
// (M rows of M + 1 each), the staged U (M * M), and the scales s, sn, the
// pivots' inverses, the carry of z, the staged b or w and the staged
// diagonal (M each)
__host__ __device__ constexpr int warp_elems(int m) {
  return 4 * m * (m + 1) + m * m + 6 * m;
}

struct BtPlan {
  int warps;    // problems per block
  size_t smem;  // dynamic shared memory bytes
};

// The launch plan of K1 for block size m and elements of `elem` bytes.
BtPlan bt_plan(int m, size_t elem) {
  const size_t per_warp = static_cast<size_t>(warp_elems(m)) * elem;
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > kDefaultSmem) warps /= 2;
  return {warps, warps * per_warp};
}

template <typename T, int M>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
bt_kernel(const T* __restrict__ D, const T* __restrict__ U,
          const T* __restrict__ b, const T* __restrict__ lam,
          T* __restrict__ x, T* __restrict__ G, int B, int n, int scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = M + 1, MM = M * M;
  constexpr int kRows = (M + 31) / 32;  // rows per lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= B) return;  // whole warps leave together

  T* C = reinterpret_cast<T*>(smem_raw) + warp * warp_elems(M);
  T* Us = C + M * LD;   // scaled off-diagonal block s_i U_i s_{i+1}
  T* X = Us + M * LD;   // [Us | z], solved in place
  T* Ds = X + M * LD;   // staged D_i (forward) or G_i (back), rows of LD
  T* Ust = Ds + M * LD; // staged U_i, M * M
  T* s = Ust + MM;      // scale of block i
  T* sn = s + M;        // scale of block i + 1
  T* inv = sn + M;      // 1 / pivot
  T* Pz = inv + M;      // carry U^T C^{-1} z; x_{i+1} in the back sweep
  T* bs = Pz + M;       // staged b_i (forward) or w_i (back)
  T* dg = bs + M;       // staged diag(D_{i+1}) (forward) or diag(D_i) (back)

  const T* Dp = D + static_cast<size_t>(p) * n * MM;
  const T* Up = U + static_cast<size_t>(p) * (n - 1) * MM;
  const T* bp = b + static_cast<size_t>(p) * n * M;
  T* xp = x + static_cast<size_t>(p) * n * M;
  T* Gp = G + static_cast<size_t>(p) * n * MM;
  const T lp = lam[p];

  // stage what forward step i reads: D_i, U_i, b_i, diag(D_{i+1})
  auto stage_forward = [&](int i) {
    const T* Di = Dp + static_cast<size_t>(i) * MM;
    for (int e = lane; e < MM; e += 32) stage(Ds + (e / M) * LD + e % M, Di + e);
    if (i < n - 1) {
      const T* Ui = Up + static_cast<size_t>(i) * MM;
      for (int e = lane; e < MM; e += 32) stage(Ust + e, Ui + e);
      for (int r = lane; r < M; r += 32) stage(dg + r, Di + MM + r * M + r);
    }
    for (int r = lane; r < M; r += 32) stage(bs + r, bp + i * M + r);
    __pipeline_commit();
  };
  // stage what back step i reads: G_i, w_i, diag(D_i)
  auto stage_back = [&](int i) {
    const T* Gi = Gp + static_cast<size_t>(i) * MM;
    for (int e = lane; e < MM; e += 32) stage(Ds + (e / M) * LD + e % M, Gi + e);
    for (int r = lane; r < M; r += 32) {
      stage(bs + r, xp + i * M + r);
      stage(dg + r, Dp + static_cast<size_t>(i) * MM + r * M + r);
    }
    __pipeline_commit();
  };

  stage_forward(0);
  for (int e = lane; e < M * LD; e += 32) C[e] = T(0);
  for (int r = lane; r < M; r += 32) Pz[r] = T(0);

  for (int i = 0; i < n; ++i) {
    const bool last = (i == n - 1);
    __pipeline_wait_prior(0);
    __syncwarp();
    for (int r = lane; r < M; r += 32) {
      if (i == 0) s[r] = scale ? jacobi(Ds[r * LD + r], lp) : T(1);
      if (!last) sn[r] = scale ? jacobi(dg[r], lp) : T(1);
    }
    __syncwarp();
    // scaled damped diagonal block minus the carry (lower triangle), z
    for (int e = lane; e < MM; e += 32) {
      const int r = e / M, c = e - r * M;
      if (c <= r) {
        const T dv = Ds[r * LD + c] + (r == c ? lp : T(0));
        C[r * LD + c] = dv * s[r] * s[c] - C[r * LD + c];
      }
    }
    for (int r = lane; r < M; r += 32) X[r * LD + M] = bs[r] * s[r] - Pz[r];
    if (!last) {
      for (int e = lane; e < MM; e += 32) {
        const int r = e / M, c = e - r * M;
        const T u = Ust[e] * s[r] * sn[c];
        Us[r * LD + c] = u;
        X[r * LD + c] = u;
      }
    }
    __syncwarp();
    if (!last) stage_forward(i + 1);  // lands while this block is factored

    // left-looking lower Cholesky C = L L^T in place, one lane per row;
    // the diagonal of L is kept only as its inverse
    for (int j = 0; j < M; ++j) {
      T v[kRows] = {};
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = j + lane + 32 * q;
        if (r < M) {
          T t = C[r * LD + j];
          for (int k = 0; k < j; ++k) t -= C[r * LD + k] * C[j * LD + k];
          v[q] = t;
        }
      }
      const T ij = dev_rsqrt(__shfl_sync(0xffffffffu, v[0], 0));
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = j + lane + 32 * q;
        if (r > j && r < M) C[r * LD + j] = v[q] * ij;
      }
      if (lane == 0) inv[j] = ij;
      __syncwarp();
    }

    // (L L^T)^{-1} [Us | z], one lane per column; only z on the last block.
    // Both sweeps read the same triangle of L, through a volatile pointer:
    // otherwise the compiler keeps the forward sweep's M (M - 1) / 2 loads
    // live for the back sweep, which under the register cap spills from
    // M = 14 in f32 and M = 10 in f64 (3.5 and 7.7 KB per thread at
    // M = 36) and made f32 at M >= 16 and f64 at M = 14 and 36 1.1-4.9x
    // slower; where nothing spilled (M <= 12 in f32) the volatile read
    // costs up to 6% (tools/time_btsolve_lread.py builds and times both).
    const volatile T* L = C;
    for (int c = (last ? M : 0) + lane; c <= M; c += 32) {
      T xc[M];  // the column, in registers: the chain is FMAs alone
#pragma unroll
      for (int r = 0; r < M; ++r) xc[r] = X[r * LD + c];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        T t = xc[r];
#pragma unroll
        for (int k = 0; k < r; ++k) t -= L[r * LD + k] * xc[k];
        xc[r] = t * inv[r];
      }
#pragma unroll
      for (int r = M - 1; r >= 0; --r) {
        T t = xc[r];
#pragma unroll
        for (int k = r + 1; k < M; ++k) t -= L[k * LD + r] * xc[k];
        xc[r] = t * inv[r];
      }
#pragma unroll
      for (int r = 0; r < M; ++r) X[r * LD + c] = xc[r];
    }
    __syncwarp();

    for (int r = lane; r < M; r += 32) xp[i * M + r] = X[r * LD + M];  // w_i
    if (!last) {
      T* Gi = Gp + static_cast<size_t>(i) * MM;
      for (int e = lane; e < MM; e += 32) {
        const int r = e / M, c = e - r * M;
        Gi[e] = X[r * LD + c];
      }
      // carry U_i^T [G_i | w_i]; the factor in C is no longer needed
      for (int e = lane; e < M * LD; e += 32) {
        const int a = e / LD, c = e - a * LD;
        T acc = T(0);
        for (int k = 0; k < M; ++k) acc += Us[k * LD + a] * X[k * LD + c];
        if (c < M) C[a * LD + c] = acc; else Pz[a] = acc;
      }
      for (int r = lane; r < M; r += 32) s[r] = sn[r];
      __syncwarp();
    }
  }

  // back substitution in the scaled space, rescaled by S on write; lane
  // k owns rows k and k + 32 of every block, as in the forward sweep, so
  // it reads back the w_i and G_i entries it wrote
  T* xn = Pz;
  for (int r = lane; r < M; r += 32) {
    const T w = X[r * LD + M];
    xn[r] = w;
    xp[(n - 1) * M + r] = w * s[r];
  }
  if (n > 1) stage_back(n - 2);
  for (int i = n - 2; i >= 0; --i) {
    __pipeline_wait_prior(0);
    __syncwarp();
    T xi[kRows], sr[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = lane + 32 * q;
      if (r < M) {
        T acc = T(0);
        for (int k = 0; k < M; ++k) acc += Ds[r * LD + k] * xn[k];
        xi[q] = bs[r] - acc;
        sr[q] = scale ? jacobi(dg[r], lp) : T(1);
      }
    }
    __syncwarp();
    if (i > 0) stage_back(i - 1);
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = lane + 32 * q;
      if (r < M) {
        xp[i * M + r] = xi[q] * sr[q];
        xn[r] = xi[q];
      }
    }
  }
}

template <typename T, int M>
cudaError_t launch(const void* D, const void* U, const void* b,
                   const void* lam, void* x, void* G, int B, int n,
                   int scale, cudaStream_t stream) {
  const BtPlan plan = bt_plan(M, sizeof(T));
  if (plan.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        bt_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + plan.warps - 1) / plan.warps;
  bt_kernel<T, M><<<grid, plan.warps * 32, plan.smem, stream>>>(
      static_cast<const T*>(D), static_cast<const T*>(U),
      static_cast<const T*>(b), static_cast<const T*>(lam),
      static_cast<T*>(x), static_cast<T*>(G), B, n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int m, const void* D, const void* U, const void* b,
                     const void* lam, void* x, void* G, int B, int n,
                     int scale, cudaStream_t stream) {
  switch (m) {
#define GPMP2_BT_CASE(MV) \
  case MV:                \
    return launch<T, MV>(D, U, b, lam, x, G, B, n, scale, stream);
    GPMP2_BT_CASE(2) GPMP2_BT_CASE(4) GPMP2_BT_CASE(6) GPMP2_BT_CASE(8)
    GPMP2_BT_CASE(10) GPMP2_BT_CASE(12) GPMP2_BT_CASE(14) GPMP2_BT_CASE(16)
    GPMP2_BT_CASE(18) GPMP2_BT_CASE(20) GPMP2_BT_CASE(22) GPMP2_BT_CASE(24)
    GPMP2_BT_CASE(26) GPMP2_BT_CASE(28) GPMP2_BT_CASE(30) GPMP2_BT_CASE(32)
    GPMP2_BT_CASE(34) GPMP2_BT_CASE(36)
#undef GPMP2_BT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// D (B,n,m,m), U (B,n-1,m,m), b (B,n,m), lam (B,) -> x (B,n,m); G is
// (B,n,m,m) scratch. All contiguous, on the stream's device.
int gpmp2_btsolve(const void* D, const void* U, const void* b,
                  const void* lam, void* x, void* G, int B, int n, int m,
                  int scale, int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? dispatch<double>(m, D, U, b, lam, x, G, B, n, scale, s)
             : dispatch<float>(m, D, U, b, lam, x, G, B, n, scale, s);
}

// K1's launch plan for block size m: out = {threads, shared bytes}.
// Returns 0, or cudaErrorInvalidValue for an m the kernel is not built for.
int gpmp2_btsolve_plan(int m, int f64, int* out) {
  if (m < 2 || m > kMaxM || m % 2) return cudaErrorInvalidValue;
  const BtPlan plan = bt_plan(m, f64 ? sizeof(double) : sizeof(float));
  out[0] = plan.warps * 32;
  out[1] = static_cast<int>(plan.smem);
  return 0;
}

const char* gpmp2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
