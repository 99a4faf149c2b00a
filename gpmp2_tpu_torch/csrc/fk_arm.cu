// K2: revolute DH arm FK + sphere centres + geometric Jacobian on Hopper.
//
// Replaces the TPU kernel gpmp2_tpu/ops/fk_arm.py:_fk_kernel (its
// pallas_call at fk_arm.py:184). Same math and outputs: the chain
// RotZ(theta + bias) * [Rx(alpha) | (a, 0, d)] from the base pose, sphere
// centres p_s = R_link(s) c_s + t_link(s), and the position Jacobian
// J[s, :, j] = [j <= link(s)] * z_j x (p_s - o_j), where joint j turns
// about the z axis of the frame before it (the base for j = 0).
//
// Design: one thread per configuration. Like the TPU kernel's two passes,
// the first loop chains the joint transforms and parks the d + 1 frames
// ([R row-major (9) | t (3)], frame 0 = base) in a thread-local array; the
// second loop reads them back for each sphere's centre and Jacobian
// columns. The structure tables (DH constants, base pose, sphere centres,
// sphere link ids) are small device tensors that every thread reads at
// the same address, so they are served from L1 as broadcasts.
//
// What bounds it on an H100: the output. At the main-path shape
// (N = 2048 * 101 = 206,848 configurations, S = 16, d = 7, f32) J is
// N * S * 3 * d * 4 B = 278 MB and the centres 40 MB, ~95 us at the
// published 3.35 TB/s, against ~N * (40 d + S * (12 + 9 d)) = 0.3 GFLOP
// of arithmetic (~5 us at the published 67 TFLOP/s f32). Each thread writes its own contiguous 1.3 KB of J, so a
// warp's stores are 32 strided streams rather than coalesced lines; the
// L2 merges them into full sectors before they reach memory. Fusing this
// kernel with the SDF gather so that J never reaches memory is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDof = 16;

__device__ __forceinline__ void dev_sincos(float v, float* s, float* c) {
  sincosf(v, s, c);
}
__device__ __forceinline__ void dev_sincos(double v, double* s, double* c) {
  sincos(v, s, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fk_kernel(const T* __restrict__ q, const T* __restrict__ consts,
          const T* __restrict__ base, const T* __restrict__ scent,
          const int* __restrict__ link_ids, T* __restrict__ centers,
          T* __restrict__ J, int N, int d, int S) {
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<size_t>(N)) return;
  const T* qp = q + p * d;

  // pass 1: frames. F[0] = base, F[j + 1] = link j.
  T F[kMaxDof + 1][12];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) F[0][3 * r + c] = base[4 * r + c];
    F[0][9 + r] = base[4 * r + 3];
  }
  for (int j = 0; j < d; ++j) {
    const T a = consts[j], dz = consts[d + j], bias = consts[2 * d + j];
    const T ca = consts[3 * d + j], sa = consts[4 * d + j];
    T st, ct;
    dev_sincos(qp[j] + bias, &st, &ct);
    // A = RotZ(theta) * [Rx(alpha) | (a, 0, dz)]:
    //   A[:,0] = (ct, st, 0); A[:,1] = (-st*ca, ct*ca, sa);
    //   A[:,2] = (st*sa, -ct*sa, ca); A[:,3] = (a*ct, a*st, dz)
    const T a10 = -st * ca, a11 = ct * ca, a12 = sa;
    const T a20 = st * sa, a21 = -ct * sa, a22 = ca;
    const T t0 = a * ct, t1 = a * st;
    const T* R = F[j];
    T* Rn = F[j + 1];
    for (int r = 0; r < 3; ++r) {
      const T r0 = R[3 * r], r1 = R[3 * r + 1], r2 = R[3 * r + 2];
      Rn[3 * r] = r0 * ct + r1 * st;
      Rn[3 * r + 1] = r0 * a10 + r1 * a11 + r2 * a12;
      Rn[3 * r + 2] = r0 * a20 + r1 * a21 + r2 * a22;
      Rn[9 + r] = R[9 + r] + r0 * t0 + r1 * t1 + r2 * dz;
    }
  }

  // pass 2: sphere centres and Jacobian columns
  T* cp = centers + p * S * 3;
  T* Jp = J + p * S * 3 * d;
  for (int s = 0; s < S; ++s) {
    const int l = link_ids[s];
    const T* Fl = F[l + 1];
    const T c0 = scent[3 * s], c1 = scent[3 * s + 1], c2 = scent[3 * s + 2];
    T pc[3];
    for (int r = 0; r < 3; ++r)
      pc[r] = Fl[3 * r] * c0 + Fl[3 * r + 1] * c1 + Fl[3 * r + 2] * c2 + Fl[9 + r];
    for (int r = 0; r < 3; ++r) cp[3 * s + r] = pc[r];
    T* Js = Jp + static_cast<size_t>(s) * 3 * d;
    for (int j = 0; j < d; ++j) {
      T jx = T(0), jy = T(0), jz = T(0);
      if (j <= l) {
        const T* Fj = F[j];
        const T zx = Fj[2], zy = Fj[5], zz = Fj[8];
        const T rx = pc[0] - Fj[9], ry = pc[1] - Fj[10], rz = pc[2] - Fj[11];
        jx = zy * rz - zz * ry;
        jy = zz * rx - zx * rz;
        jz = zx * ry - zy * rx;
      }
      Js[j] = jx;
      Js[d + j] = jy;
      Js[2 * d + j] = jz;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* consts, const void* base,
                   const void* scent, const void* link_ids, void* centers,
                   void* J, int N, int d, int S, cudaStream_t stream) {
  if (d < 1 || d > kMaxDof) return cudaErrorInvalidValue;
  const int grid = (N + kThreads - 1) / kThreads;
  fk_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(consts),
      static_cast<const T*>(base), static_cast<const T*>(scent),
      static_cast<const int*>(link_ids), static_cast<T*>(centers),
      static_cast<T*>(J), N, d, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (N,d), consts (5,d) = [a, dz, theta_bias, cos alpha, sin alpha],
// base (3,4) = [R | t], scent (S,3), link_ids (S,) int32 ->
// centers (N,S,3), J (N,S,3,d). All contiguous, on the stream's device.
int gpmp2_fk_arm(const void* q, const void* consts, const void* base,
                 const void* scent, const void* link_ids, void* centers,
                 void* J, int N, int d, int S, int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(q, consts, base, scent, link_ids, centers, J,
                              N, d, S, s)
             : launch<float>(q, consts, base, scent, link_ids, centers, J,
                             N, d, S, s);
}

}  // extern "C"
