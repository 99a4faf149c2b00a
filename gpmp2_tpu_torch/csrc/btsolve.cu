// K1: batched block-tridiagonal SPD solve x = (H + lam I)^{-1} b on Hopper.
//
// Replaces the TPU kernel gpmp2_tpu/ops/btsolve.py:_bt_kernel (its
// pallas_call at btsolve.py:237). Same math: per problem, symmetric Jacobi
// scaling S = diag(rsqrt(max(diag(D) + lam, 1e-30))) folded in (the
// damped, scaled operands never reach device memory), a forward block
// Cholesky sweep that stores G_i = C_i^{-1} U_i and w_i = C_i^{-1} z_i and
// carries U_i^T [G_i | w_i], then back substitution and the rescale by S.
//
// Design: one thread per problem; the sequential sweep over the n blocks
// is a loop inside the thread, where the TPU ran a fori_loop inside one
// grid step over a 128-lane tile of problems. Block size M is a template
// parameter (M in {2, 4, ..., 34}); n is a runtime value. The per-step
// m x m working set (carry/factor, scaled U, the [U | z] right-hand side)
// lives in thread-local arrays, which spill to local memory at M = 14; the
// G_i blocks go to a (B, n, M, M) scratch tensor the wrapper allocates.
//
// What bounds it on an H100: the main-path shape (B = 2048, n = 11,
// M = 14, f32) moves ~68 MB (D, U, b in; G out and back; x out), ~20 us
// at the published 3.35 TB/s, but it launches only B threads (64 blocks
// of 32, half the SMs) and each thread runs ~n * 7M^3/3 = 70k dependent
// FMAs through local memory, so the kernel is latency-bound on the serial
// recurrence, not on bytes or FLOPs.
// Loads are batch-first and uncoalesced: neighbouring threads read
// addresses n*M*M elements apart. A warp-per-problem layout with the
// blocks in shared memory, and coalesced loads, are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// rsqrt(max(v, 1e-30)) with NaN propagating like jnp.maximum
template <typename T>
__device__ __forceinline__ T jacobi(T diag, T lam) {
  T v = diag + lam;
  v = (v < T(1e-30)) ? T(1e-30) : v;
  return T(1) / dev_sqrt(v);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
bt_kernel(const T* __restrict__ D, const T* __restrict__ U,
          const T* __restrict__ b, const T* __restrict__ lam,
          T* __restrict__ x, T* __restrict__ G, int B, int n, int scale) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  constexpr int MM = M * M;
  const T* Dp = D + static_cast<size_t>(p) * n * MM;
  const T* Up = U + static_cast<size_t>(p) * (n - 1) * MM;
  const T* bp = b + static_cast<size_t>(p) * n * M;
  T* xp = x + static_cast<size_t>(p) * n * M;
  T* Gp = G + static_cast<size_t>(p) * n * MM;
  const T lp = lam[p];

  T C[M][M];      // carry U^T C^{-1} U, then the block C_i and its factor L
  T Pz[M];        // carry U^T C^{-1} z
  T Us[M][M];     // scaled off-diagonal block s_i U_i s_{i+1}
  T X[M][M + 1];  // right-hand side [Us | z], solved in place
  T s[M], sn[M], inv[M];

  for (int r = 0; r < M; ++r) {
    Pz[r] = T(0);
    for (int c = 0; c < M; ++c) C[r][c] = T(0);
    s[r] = scale ? jacobi(Dp[r * M + r], lp) : T(1);
  }

  for (int i = 0; i < n; ++i) {
    const T* Di = Dp + static_cast<size_t>(i) * MM;
    const bool last = (i == n - 1);
    // scaled damped diagonal block minus carry (lower triangle)
    for (int r = 0; r < M; ++r) {
      for (int c = 0; c <= r; ++c) {
        const T dv = Di[r * M + c] + (r == c ? lp : T(0));
        C[r][c] = dv * s[r] * s[c] - C[r][c];
      }
      X[r][M] = bp[i * M + r] * s[r] - Pz[r];
    }
    if (!last) {
      const T* Dn = Di + MM;
      const T* Ui = Up + static_cast<size_t>(i) * MM;
      for (int c = 0; c < M; ++c)
        sn[c] = scale ? jacobi(Dn[c * M + c], lp) : T(1);
      for (int r = 0; r < M; ++r)
        for (int c = 0; c < M; ++c) {
          Us[r][c] = Ui[r * M + c] * s[r] * sn[c];
          X[r][c] = Us[r][c];
        }
    }
    // lower Cholesky C = L L^T in place
    for (int j = 0; j < M; ++j) {
      T v = C[j][j];
      for (int k = 0; k < j; ++k) v -= C[j][k] * C[j][k];
      const T dj = dev_sqrt(v);
      C[j][j] = dj;
      inv[j] = T(1) / dj;
      for (int r = j + 1; r < M; ++r) {
        T t = C[r][j];
        for (int k = 0; k < j; ++k) t -= C[r][k] * C[j][k];
        C[r][j] = t * inv[j];
      }
    }
    // (L L^T)^{-1} [Us | z]; only the z column on the last block
    for (int c = last ? M : 0; c <= M; ++c) {
      for (int r = 0; r < M; ++r) {
        T t = X[r][c];
        for (int k = 0; k < r; ++k) t -= C[r][k] * X[k][c];
        X[r][c] = t * inv[r];
      }
      for (int r = M - 1; r >= 0; --r) {
        T t = X[r][c];
        for (int k = r + 1; k < M; ++k) t -= C[k][r] * X[k][c];
        X[r][c] = t * inv[r];
      }
    }
    for (int r = 0; r < M; ++r) xp[i * M + r] = X[r][M];  // w_i
    if (!last) {
      T* Gi = Gp + static_cast<size_t>(i) * MM;
      for (int r = 0; r < M; ++r)
        for (int c = 0; c < M; ++c) Gi[r * M + c] = X[r][c];
      // carry U_i^T [G_i | w_i]; the factor in C is no longer needed
      for (int a = 0; a < M; ++a) {
        for (int c = 0; c <= M; ++c) {
          T acc = T(0);
          for (int k = 0; k < M; ++k) acc += Us[k][a] * X[k][c];
          if (c < M) C[a][c] = acc; else Pz[a] = acc;
        }
      }
      for (int r = 0; r < M; ++r) s[r] = sn[r];
    }
  }

  // back substitution in the scaled space, rescaled by S on write
  T xn[M];
  for (int r = 0; r < M; ++r) {
    xn[r] = xp[(n - 1) * M + r];
    xp[(n - 1) * M + r] = xn[r] * s[r];
  }
  for (int i = n - 2; i >= 0; --i) {
    const T* Di = Dp + static_cast<size_t>(i) * MM;
    const T* Gi = Gp + static_cast<size_t>(i) * MM;
    T xi[M];
    for (int r = 0; r < M; ++r) {
      T acc = T(0);
      for (int k = 0; k < M; ++k) acc += Gi[r * M + k] * xn[k];
      xi[r] = xp[i * M + r] - acc;
    }
    for (int r = 0; r < M; ++r) {
      const T sr = scale ? jacobi(Di[r * M + r], lp) : T(1);
      xp[i * M + r] = xi[r] * sr;
      xn[r] = xi[r];
    }
  }
}

template <typename T, int M>
cudaError_t launch(const void* D, const void* U, const void* b,
                   const void* lam, void* x, void* G, int B, int n,
                   int scale, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  bt_kernel<T, M><<<grid, kThreads, 0, stream>>>(
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
    GPMP2_BT_CASE(34)
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

const char* gpmp2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
