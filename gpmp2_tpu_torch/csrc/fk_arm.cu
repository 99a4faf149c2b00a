// K2: revolute DH arm FK + sphere centres + geometric Jacobian on Hopper.
//
// Replaces the TPU kernel gpmp2_tpu/ops/fk_arm.py:_fk_kernel (its
// pallas_call at fk_arm.py:184). Same math and outputs: the chain
// RotZ(theta + bias) * [Rx(alpha) | (a, 0, d)] from the base pose, sphere
// centres p_s = R_link(s) c_s + t_link(s), and the position Jacobian
// J[s, :, j] = [j <= link(s)] * z_j x (p_s - o_j), where joint j turns
// about the z axis of the frame before it (the base for j = 0).
//
// What bounds it on an H100: writing the output. At the main-path shape
// (N = 2048 * 101 = 206,848 configurations, S = 16, d = 7, f32) J is
// N * S * 3 * d * 4 B = 278 MB and the centres 40 MB, ~95 us at the
// published 3.35 TB/s, against ~0.3 GFLOP of arithmetic (~5 us at the
// published 67 TFLOP/s f32). The first port (one thread per
// configuration) kept the frames in a local-memory array indexed by the
// runtime link id, and each thread stored its own contiguous 1.3 KB of J,
// so a warp's store touched 32 lines 1.3 KB apart: ~145 GB/s.
//
// Design: one block of kThreads threads per tile of P configurations.
//   1. One thread per configuration chains the d + 1 frames
//      ([R row-major (9) | t (3)], frame 0 = base) in registers and parks
//      them in shared memory.
//   2. Threads over (configuration, sphere) compute the centres into
//      shared memory; the tile's centres, one contiguous span of the
//      output, go out as coalesced 16-byte vectors.
//   3. The tile's J is one contiguous span of P * S * 3 * d elements. It is
//      built in chunks of whole (configuration, sphere) rows in shared
//      memory: one thread per (configuration, sphere, joint) computes the
//      three components of z_j x (c - o_j) from the frames and centres,
//      then the chunk is copied out in address order, one 16-byte vector
//      per thread and step, so every global store is a full coalesced
//      line and each J element costs a few instructions.
// P and the chunk's row count are multiples of the vector width, so every
// span starts 16-byte aligned; the ragged tail of the last tile is stored
// element by element. d is a template parameter (1..16), so the offset
// arithmetic divides by constants. fk_plan picks P: the largest power of
// two up to 64 whose tile and chunk fit in 48 KB of shared memory (several
// blocks per SM keep the stores in flight), else the smallest tile with
// the opt-in above 48 KB; a tile that does not fit in 227 KB is refused.
// The launch bounds ask for 4 resident blocks of 256 threads per SM,
// which caps the registers at 64 (128 bytes a thread spill at the main
// shape); on the card that ran faster than 2 blocks without a cap.
// What still bounds it: the bytes, at ~1.5x their bound; the frame chain
// of phase 1 runs on P of the 256 threads while the rest wait.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // resident blocks per SM the registers must allow
constexpr int kMaxDof = 16;
constexpr int kMaxTile = 64;
constexpr int kChunkElems = 4096;  // J elements staged per chunk
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt in to

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ void dev_sincos(float v, float* s, float* c) {
  sincosf(v, s, c);
}
__device__ __forceinline__ void dev_sincos(double v, double* s, double* c) {
  sincos(v, s, c);
}

struct FkPlan {
  int tile;     // configurations per block, P
  int threads;  // threads per block
  size_t smem;  // dynamic shared memory bytes
};

// The launch plan of K2 for d joints, S spheres and elements of `elem`
// bytes; false if no tile fits.
bool fk_plan(int d, int S, size_t elem, FkPlan* plan) {
  if (d < 1 || d > kMaxDof || S < 0) return false;
  const size_t per_conf = static_cast<size_t>((d + 1) * 12 + 3 * S) * elem;
  const int vec = static_cast<int>(16 / elem);
  const size_t chunk = kChunkElems * elem;
  int tile = kMaxTile;
  while (tile > vec && tile * per_conf + chunk > kDefaultSmem) tile /= 2;
  if (tile * per_conf + chunk > kMaxSmem) return false;
  *plan = {tile, kThreads, tile * per_conf + chunk};
  return true;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fk_kernel(const T* __restrict__ q, const T* __restrict__ consts,
          const T* __restrict__ base, const T* __restrict__ scent,
          const int* __restrict__ link_ids, T* __restrict__ centers,
          T* __restrict__ J, int N, int S, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int FS = (D + 1) * 12;  // frame values per configuration
  constexpr int ROW = 3 * D;        // J elements per (configuration, sphere)
  using V = Vec16<T>;
  T* F = reinterpret_cast<T*>(smem_raw);  // [P][D + 1][12]
  T* Cs = F + P * FS;                     // [P][S][3]
  const int p0 = blockIdx.x * P;
  const int np = min(P, N - p0);
  const int tid = threadIdx.x;

  // 1. frames, one thread per configuration
  for (int p = tid; p < np; p += blockDim.x) {
    const T* qp = q + static_cast<size_t>(p0 + p) * D;
    T* Fp = F + p * FS;
    T R[9], t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) R[3 * r + c] = base[4 * r + c];
      t[r] = base[4 * r + 3];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) Fp[k] = R[k];
#pragma unroll
    for (int r = 0; r < 3; ++r) Fp[9 + r] = t[r];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const T a = consts[j], dz = consts[D + j], bias = consts[2 * D + j];
      const T ca = consts[3 * D + j], sa = consts[4 * D + j];
      T st, ct;
      dev_sincos(qp[j] + bias, &st, &ct);
      // A = RotZ(theta) * [Rx(alpha) | (a, 0, dz)]:
      //   A[:,0] = (ct, st, 0); A[:,1] = (-st*ca, ct*ca, sa);
      //   A[:,2] = (st*sa, -ct*sa, ca); A[:,3] = (a*ct, a*st, dz)
      const T a10 = -st * ca, a11 = ct * ca, a12 = sa;
      const T a20 = st * sa, a21 = -ct * sa, a22 = ca;
      const T t0 = a * ct, t1 = a * st;
      T* Fn = Fp + (j + 1) * 12;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T r0 = R[3 * r], r1 = R[3 * r + 1], r2 = R[3 * r + 2];
        R[3 * r] = r0 * ct + r1 * st;
        R[3 * r + 1] = r0 * a10 + r1 * a11 + r2 * a12;
        R[3 * r + 2] = r0 * a20 + r1 * a21 + r2 * a22;
        t[r] = t[r] + r0 * t0 + r1 * t1 + r2 * dz;
        Fn[3 * r] = R[3 * r];
        Fn[3 * r + 1] = R[3 * r + 1];
        Fn[3 * r + 2] = R[3 * r + 2];
        Fn[9 + r] = t[r];
      }
    }
  }
  __syncthreads();

  // 2. centres, threads over (configuration, sphere)
  for (int e = tid; e < np * S; e += blockDim.x) {
    const int p = e / S, s = e - p * S;
    const T* Fl = F + p * FS + (link_ids[s] + 1) * 12;
    const T c0 = scent[3 * s], c1 = scent[3 * s + 1], c2 = scent[3 * s + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      Cs[3 * e + r] = Fl[3 * r] * c0 + Fl[3 * r + 1] * c1 + Fl[3 * r + 2] * c2 + Fl[9 + r];
  }
  __syncthreads();

  // 3a. the tile's centres: one contiguous span, in 16-byte vectors
  {
    const int total = np * S * 3;
    T* out = centers + static_cast<size_t>(p0) * S * 3;
    const int nvec = total / V::n;
    for (int v = tid; v < nvec; v += blockDim.x)
      reinterpret_cast<typename V::type*>(out)[v] =
          reinterpret_cast<const typename V::type*>(Cs)[v];
    for (int e = nvec * V::n + tid; e < total; e += blockDim.x) out[e] = Cs[e];
  }

  // 3b. the tile's J, one contiguous span, in chunks of whole
  // (configuration, sphere) rows staged in shared memory: one thread per
  // (p, s, j) computes z_j x (c_ps - o_j), zero for j > link(s), into the
  // chunk's rows, then the chunk goes out in 16-byte vectors in address
  // order. The chunk's row count is a multiple of the vector width, so
  // every chunk starts 16-byte aligned.
  constexpr int kRowsPerChunk = kChunkElems / ROW / V::n * V::n;
  T* Jt = Cs + P * S * 3;  // [kRowsPerChunk][3][D]
  const int rows = np * S;
  for (int ps0 = 0; ps0 < rows; ps0 += kRowsPerChunk) {
    const int nr = min(kRowsPerChunk, rows - ps0);
    for (int it = tid; it < nr * D; it += blockDim.x) {
      const int pr = it / D, j = it - pr * D;
      const int ps = ps0 + pr, s = ps % S;
      T* o3 = Jt + pr * ROW + j;
      if (j > link_ids[s]) {
        o3[0] = o3[D] = o3[2 * D] = T(0);
        continue;
      }
      const T* Fj = F + (ps / S) * FS + j * 12;
      const T* c = Cs + 3 * ps;
      const T zx = Fj[2], zy = Fj[5], zz = Fj[8];
      const T rx = c[0] - Fj[9], ry = c[1] - Fj[10], rz = c[2] - Fj[11];
      o3[0] = zy * rz - zz * ry;
      o3[D] = zz * rx - zx * rz;
      o3[2 * D] = zx * ry - zy * rx;
    }
    __syncthreads();
    const int total = nr * ROW;
    T* out = J + (static_cast<size_t>(p0) * S + ps0) * ROW;
    const int nvec = total / V::n;
    for (int v = tid; v < nvec; v += blockDim.x)
      reinterpret_cast<typename V::type*>(out)[v] =
          reinterpret_cast<const typename V::type*>(Jt)[v];
    for (int e = nvec * V::n + tid; e < total; e += blockDim.x) out[e] = Jt[e];
    __syncthreads();
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* consts, const void* base,
                     const void* scent, const void* link_ids, void* centers,
                     void* J, int N, int S, const FkPlan& plan,
                     cudaStream_t stream) {
  auto kernel = fk_kernel<T, D>;
  if (plan.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (N + plan.tile - 1) / plan.tile;
  kernel<<<grid, plan.threads, plan.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(consts),
      static_cast<const T*>(base), static_cast<const T*>(scent),
      static_cast<const int*>(link_ids), static_cast<T*>(centers),
      static_cast<T*>(J), N, S, plan.tile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* consts, const void* base,
                   const void* scent, const void* link_ids, void* centers,
                   void* J, int N, int d, int S, cudaStream_t stream) {
  FkPlan plan;
  if (!fk_plan(d, S, sizeof(T), &plan)) return cudaErrorInvalidValue;
  switch (d) {
#define GPMP2_FK_CASE(DV)                                                  \
  case DV:                                                                 \
    return launch_d<T, DV>(q, consts, base, scent, link_ids, centers, J, N, \
                           S, plan, stream);
    GPMP2_FK_CASE(1) GPMP2_FK_CASE(2) GPMP2_FK_CASE(3) GPMP2_FK_CASE(4)
    GPMP2_FK_CASE(5) GPMP2_FK_CASE(6) GPMP2_FK_CASE(7) GPMP2_FK_CASE(8)
    GPMP2_FK_CASE(9) GPMP2_FK_CASE(10) GPMP2_FK_CASE(11) GPMP2_FK_CASE(12)
    GPMP2_FK_CASE(13) GPMP2_FK_CASE(14) GPMP2_FK_CASE(15) GPMP2_FK_CASE(16)
#undef GPMP2_FK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (N,d), consts (5,d) = [a, dz, theta_bias, cos alpha, sin alpha],
// base (3,4) = [R | t], scent (S,3), link_ids (S,) int32 ->
// centers (N,S,3), J (N,S,3,d). All contiguous, on the stream's device;
// centers and J 16-byte aligned.
int gpmp2_fk_arm(const void* q, const void* consts, const void* base,
                 const void* scent, const void* link_ids, void* centers,
                 void* J, int N, int d, int S, int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(q, consts, base, scent, link_ids, centers, J,
                              N, d, S, s)
             : launch<float>(q, consts, base, scent, link_ids, centers, J,
                             N, d, S, s);
}

// K2's launch plan for (d, S, dtype): out = {P, threads, shared bytes}.
// Returns 0, or cudaErrorInvalidValue where no tile fits.
int gpmp2_fk_arm_plan(int d, int S, int f64, int* out) {
  FkPlan plan;
  if (!fk_plan(d, S, f64 ? sizeof(double) : sizeof(float), &plan))
    return cudaErrorInvalidValue;
  out[0] = plan.tile;
  out[1] = plan.threads;
  out[2] = static_cast<int>(plan.smem);
  return 0;
}

}  // extern "C"
