// The assembly kernel: the vector-space linearize's normal equations on
// Hopper, from the outputs of K2 (fk_arm.cu) and K3 (sdf_lookup.cu).
//
// Replaces no TPU kernel: the JAX package leaves this assembly to XLA's
// fusions (gpmp2_tpu/planner/problem.py), and the port ran it as ~250
// PyTorch operations a linearize, a cuBLAS batched GEMM/GEMV or an
// elementwise pass each. One launch writes what they wrote, for a batch
// of B vector-space problems of n support states (m = 2d: z = [x; v]),
// T interpolated states an interval and S spheres
// (planner/problem.py::traj_linearize, whose torch code stays the twin):
//   - the hinge r = eps_total - dist on active (in range and within
//     eps_total) spheres, and J = -g . Jc, both zero elsewhere;
//   - the support states' obstacle J^T W J, J^T W r on their pose block;
//   - each interval's interpolated obstacle factors by the factored Gram:
//     G_t = J^T J, g_t = J^T r over the spheres of its tau t, pushed
//     through the constant coefficients C_t = [Lambda | Psi][:d] (d, 2m)
//     into the widened (2m, 2m) block sum_t C_t^T G_t C_t and sum_t
//     C_t^T g_t, times the obstacle precision;
//   - the start and goal priors (diagonal on a vector space);
//   - the GP prior of each interval with its constant Jacobians J1, J2 and
//     full precision W: r = J1 z_i + J2 z_i+1;
//   - the total error 0.5 r^T W r.
// H_diag (B, n, m, m), H_off (B, n-1, m, m), b (B, n, m) and err (B,) are
// written once each, with no atomics, so two runs agree bit for bit.
//
// What bounds it on an H100: reading K2's Jacobians. At the main path
// (B = 2048, n = 11, T = 9, S = 16, d = 7, f32) Jc is 2048 * 101 * 16 * 21
// * 4 B = 278 MB, K3's four value arrays and its mask 56 MB, the outputs
// 35 MB: ~0.11 ms at the published 3.35 TB/s, against ~1.4 GFLOP.
//
// Design: persistent blocks of kThreads threads, as many as fit on the
// card, each walking plans blockIdx.x, + gridDim.x, ...; a block walks a
// plan's support states in order. Unit u is support state u and, for
// u < n - 1, the T interpolated states of interval u. The chunks of a
// block (up to Kc states of a unit) stream through two shared-memory
// buffers by cp.async, 16 bytes a copy where the rows allow: the next
// chunk, of this plan or the block's next one, is in flight while the
// current one is reduced. A chunk is reduced by a thread a (state,
// sphere), which forms J, then by a thread two entries of a row of each
// state's G (upper triangle) and g. Where every C_t is
// [a0 I | a1 I | a2 I | a3 I] exactly (Qc = c I; checked once a block),
// the widened block's entries are sum_t a_p a_q G_t, summed by the thread
// that writes them; else
// GC_t = G_t C_t, a row a thread, and 2 x 2 output tiles of
// sum_t C_t^T GC_t, the sum over (t, j) split in two. H_diag[u],
// H_off[u] and b[u] are written, each entry by one thread, while
// H_diag[u + 1]'s and b[u + 1]'s share of interval u is carried in shared
// memory to the next unit. d is a template parameter (1..kMaxDof).
// The coefficients are read through the caches, and a chunk's J rows
// share their shared memory with the general path's GC and tiles, so that
// four blocks fit on an SM at the main path (55 KB each; 64 registers).
// What still bounds it: the latency of a unit's phases (four barriers on
// the Qc = c I path; the copies land in time), at about one instruction a
// cycle an SM.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // resident blocks per SM the registers must allow
constexpr int kMaxDof = 8;
constexpr int kMaxSpheres = 64;
constexpr int kMaxInter = 16;
constexpr size_t kSmemTarget = 96 * 1024;  // a chunk's size is cut to fit this
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt in to

template <typename T>
struct Args {
  const T* pose;        // (B, n, d)
  const T* vel;         // (B, n, d)
  const T* Jc;          // (B, C, S, 3, d), C = n + (n-1) T
  const T* dist;        // (B, C, S)
  const T* gx;          // (B, C, S)
  const T* gy;          // (B, C, S)
  const T* gz;          // (B, C, S), null on a planar field
  const uint8_t* ok;    // (B, C, S) bool
  const T* eps_total;   // (S,)
  const T* obs_w;       // ()
  const T* coeff;       // (T, d, 2m), null when T = 0
  const T* J1;          // (m, m)
  const T* J2;          // (m, m)
  const T* W;           // (m, m)
  const T* start_pose;  // (B, d)
  const T* start_vel;   // (B, d)
  const T* pose_w;      // (d,)
  const T* vel_w;       // (d,)
  const T* end_pose;    // (B, d)
  const T* end_vel;     // (B, d)
  const T* goal_pose_w; // (B, d)
  const T* goal_vel_w;  // (B, d)
  T* H_diag;            // (B, n, m, m)
  T* H_off;             // (B, n-1, m, m)
  T* b;                 // (B, n, m)
  T* err;               // (B,)
  int B, n, S, T_, goal_prior, jc_vec, k3_vec, ok_vec;
};

// Shared-memory layout, in elements of T from the start; each region
// starts on a 16-byte boundary.
struct Layout {
  int Kc;  // states a chunk
  size_t acoef, kron, W, J1, J2, Q1, Q2, A11, A12, A22, eps, stage, stage_size, st_k3, st_ok,
      st_z, jrow, rr, ustore, GC, Hf, rgp, nextH, nextb, z, red, total;
};

__host__ __device__ constexpr size_t align16(size_t elems, size_t elem) {
  const size_t per = 16 / elem;
  return (elems + per - 1) / per * per;
}

// The launch plan for d, S, T and elements of `elem` bytes: the chunk of
// Kc states is the whole unit (T + 1 states) where that fits kSmemTarget,
// else as many states as fit; false where one state does not fit.
bool assemble_plan(int d, int S, int T, size_t elem, Layout* L) {
  if (d < 1 || d > kMaxDof || S < 1 || S > kMaxSpheres || T < 0 || T > kMaxInter)
    return false;
  const int m = 2 * d, m2 = 4 * d, P = d * (d + 1) / 2;
  size_t off = 0;
  auto take = [&](size_t elems) {
    const size_t at = off;
    off += align16(elems, elem);
    return at;
  };
  Layout l{};
  l.acoef = take(4 * static_cast<size_t>(T));
  l.kron = take(10 * static_cast<size_t>(T));
  l.W = take(m * m);
  l.J1 = take(m * m);
  l.J2 = take(m * m);
  l.Q1 = take(m * m);
  l.Q2 = take(m * m);
  l.A11 = take(m * m);
  l.A12 = take(m * m);
  l.A22 = take(m * m);
  l.eps = take(S);
  l.ustore = take(static_cast<size_t>(T + 1) * (P + d));
  l.rgp = take(m);
  l.nextH = take(m * m);
  l.nextb = take(m);
  l.z = take(4 * d);
  l.red = take(2 * kThreads / 32);
  const size_t fixed = off;
  // the stage: two buffers of a chunk's Jc rows, K3 values, ok bytes and
  // end states; then the chunk's J rows and residuals
  auto stage_of = [&](int kc) {
    const size_t ok_elems = (static_cast<size_t>(kc) * S + elem - 1) / elem;
    return align16(static_cast<size_t>(kc) * S * 3 * d, elem) +
           align16(static_cast<size_t>(4) * kc * S, elem) + align16(ok_elems, elem) +
           align16(4 * d, elem);
  };
  // the chunk's J rows and residuals (its reduction) share one region
  // with the general coefficients' GC and tiles (the unit's end)
  const size_t gen = align16(static_cast<size_t>(T) * d * m2, elem) + align16(2 * m2 * m2, elem);
  auto shared_of = [&](int kc) {
    const size_t red_ = align16(static_cast<size_t>(kc) * S * d, elem) +
                        align16(static_cast<size_t>(kc) * S, elem);
    return red_ > gen ? red_ : gen;
  };
  auto total_of = [&](int kc) { return (fixed + 2 * stage_of(kc) + shared_of(kc)) * elem; };
  int kc = T + 1;
  while (kc > 1 && total_of(kc) > kSmemTarget) --kc;
  if (total_of(kc) > kMaxSmem) return false;
  l.Kc = kc;
  l.stage_size = stage_of(kc);
  l.st_k3 = align16(static_cast<size_t>(kc) * S * 3 * d, elem);
  l.st_ok = l.st_k3 + align16(static_cast<size_t>(4) * kc * S, elem);
  l.st_z = l.stage_size - align16(4 * d, elem);
  l.stage = take(2 * l.stage_size);
  const size_t region = take(shared_of(kc));
  l.jrow = region;
  l.rr = region + align16(static_cast<size_t>(kc) * S * d, elem);
  l.GC = region;
  l.Hf = region + align16(static_cast<size_t>(T) * d * m2, elem);
  l.total = off * elem;
  *L = l;
  return true;
}

// (j, l), j <= l, of entry e of a packed upper triangle of side D
__device__ __forceinline__ void upper_pair(int e, int D, int* j, int* l) {
  int r = 0;
  while (e >= D - r) {
    e -= D - r;
    ++r;
  }
  *j = r;
  *l = r + e;
}

__device__ __forceinline__ int upper_index(int j, int l, int D) {
  if (j > l) {
    const int t = j;
    j = l;
    l = t;
  }
  return j * D - j * (j - 1) / 2 + (l - j);
}

// reduction items of a state's [G | g]: row j's D - j + 1 entries, two an item
__host__ __device__ constexpr int gram_items(int D) {
  int c = 0;
  for (int j = 0; j < D; ++j) c += (D - j + 2) / 2;
  return c;
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
assemble_vec_kernel(const Args<T> a, const Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int M = 2 * D, M2 = 4 * D, P = D * (D + 1) / 2, E = P + D;
  constexpr int Q = 2 * D, NT = Q * (Q + 1) / 2;  // 2 x 2 tiles of the widened block
  constexpr int V = 16 / sizeof(T);                // elements a 16-byte copy
  const int n = a.n, S = a.S, TT = a.T_, Kc = L.Kc, B = a.B;
  const int C = n + (n - 1) * TT, ROW = S * 3 * D;
  const int tid = threadIdx.x, nth = blockDim.x;
  // thread tid takes sphere tid % S of states tid / S, + nth / S, ... (S <= nth)
  const int my_s = tid % S, my_k0 = tid / S, k_step = nth / S;

  const T* coeff = a.coeff;  // read through the caches; the Qc = c I path reads acoef
  T* acoef = sm + L.acoef;
  T* kron = sm + L.kron;
  T* W = sm + L.W;
  T* J1 = sm + L.J1;
  T* J2 = sm + L.J2;
  T* Q1 = sm + L.Q1;
  T* Q2 = sm + L.Q2;
  T* A11 = sm + L.A11;
  T* A12 = sm + L.A12;
  T* A22 = sm + L.A22;
  T* eps = sm + L.eps;
  T* jrow = sm + L.jrow;
  T* rr = sm + L.rr;
  T* ustore = sm + L.ustore;
  T* GC = sm + L.GC;
  T* Hf = sm + L.Hf;
  T* rgp = sm + L.rgp;
  T* nextH = sm + L.nextH;
  T* nextb = sm + L.nextb;
  T* z = sm + L.z;
  T* red = sm + L.red;
  // a state's reduction items: row j of [G | g], entries (j, j) .. (j, D - 1)
  // of G and (j, D) of g, taken two at a time: (j, l1, l2), l2 = 255 where
  // the row's last item has one entry
  constexpr int NI = gram_items(D);
  __shared__ unsigned char items[3 * NI];

  auto unit_states = [&](int u) { return 1 + (u < n - 1 ? TT : 0); };
  auto state_of = [&](int u, int j) { return j == 0 ? u : n + u * TT + (j - 1); };

  // A chunk: plan bi, unit u, its states j0 .. j0 + Kc - 1 (or fewer)
  struct Chunk {
    size_t bi;
    int u, j0;
  };
  auto next_chunk = [&](Chunk c) {
    c.j0 += Kc;
    if (c.j0 >= unit_states(c.u)) {
      c.j0 = 0;
      if (++c.u == n) {
        c.u = 0;
        c.bi += gridDim.x;
      }
    }
    return c;
  };
  auto valid = [&](const Chunk& c) { return c.bi < static_cast<size_t>(B); };
  auto chunk_states = [&](const Chunk& c) { return min(Kc, unit_states(c.u) - c.j0); };

  // cp.async copies of chunk c into stage buffer `buf`: the states' Jc
  // rows, their dist/gx/gy/gz and ok bytes, and with the unit's first
  // chunk the unit's end states z_u, z_u+1; 16 bytes a copy where the
  // rows allow
  const int jc_per = a.jc_vec ? ROW / V : ROW;  // copies of a state's Jc row
  const int k3_per = a.k3_vec ? S / V : S;      // of one of its K3 arrays
  const int ok_per = a.ok_vec ? S / 4 : S;      // of its ok bytes
  const int narr = a.gz ? 4 : 3;
  auto issue = [&](int buf, const Chunk& c) {
    T* st = sm + L.stage + buf * L.stage_size;
    const int kc = chunk_states(c);
    const size_t first = c.bi * C;
    for (int it = tid; it < kc * jc_per; it += nth) {
      const int k = it / jc_per, v = it - k * jc_per;
      const T* src = a.Jc + (first + state_of(c.u, c.j0 + k)) * ROW;
      if (a.jc_vec)
        __pipeline_memcpy_async(st + k * ROW + v * V, src + v * V, 16);
      else
        copy_async(st + k * ROW + v, src + v);
    }
    T* k3 = st + L.st_k3;
    for (int it = tid; it < narr * Kc * k3_per; it += nth) {
      const int row = it / k3_per, v = it - row * k3_per;  // row = arr * Kc + k
      const int arr = row / Kc, k = row - arr * Kc;
      if (k >= kc) continue;
      const T* src = (arr == 0 ? a.dist : arr == 1 ? a.gx : arr == 2 ? a.gy : a.gz) +
                     (first + state_of(c.u, c.j0 + k)) * S;
      if (a.k3_vec)
        __pipeline_memcpy_async(k3 + row * S + v * V, src + v * V, 16);
      else
        copy_async(k3 + row * S + v, src + v);
    }
    uint8_t* okd = reinterpret_cast<uint8_t*>(st + L.st_ok);
    for (int it = tid; it < kc * ok_per; it += nth) {
      const int k = it / ok_per, w = it - k * ok_per;
      const uint8_t* src = a.ok + (first + state_of(c.u, c.j0 + k)) * S;
      if (a.ok_vec)
        __pipeline_memcpy_async(okd + k * S + 4 * w, src + 4 * w, 4);
      else
        okd[k * S + w] = src[w];
    }
    if (c.j0 == 0) {
      T* zs = st + L.st_z;
      const int nz = c.u < n - 1 ? 4 * D : 2 * D;
      for (int it = tid; it < nz; it += nth) {
        const int which = it / D, j = it - which * D;
        const T* src = (which & 1) ? a.vel : a.pose;
        copy_async(zs + it, src + (c.bi * n + c.u + (which >> 1)) * D + j);
      }
    }
  };

  // the block's first chunk goes out before the constants are staged
  Chunk cur{blockIdx.x, 0, 0};
  if (valid(cur)) issue(0, cur);
  __pipeline_commit();

  for (int it = tid; it < 4 * TT; it += nth) acoef[it] = coeff[(it / 4) * D * M2 + (it % 4) * D];
  for (int it = tid; it < M * M; it += nth) {
    W[it] = a.W[it];
    J1[it] = a.J1[it];
    J2[it] = a.J2[it];
  }
  for (int it = tid; it < S; it += nth) eps[it] = a.eps_total[it];
  if (tid == 0) {
    int i = 0;
    for (int j = 0; j < D; ++j) {
      for (int l = j; l <= D; l += 2, ++i) {
        items[3 * i] = static_cast<unsigned char>(j);
        items[3 * i + 1] = static_cast<unsigned char>(l);
        items[3 * i + 2] = static_cast<unsigned char>(l + 1 <= D ? l + 1 : 255);
      }
    }
  }
  __syncthreads();
  // Is every C_t a row of four multiples of the identity, [a0 I | a1 I |
  // a2 I | a3 I], exactly (as for Qc = c I)? Then the widened block is
  // sum_t (a_t a_t^T) (x) G_t, with no product with an exact zero.
  bool kron_ok = true;
  for (int it = tid; it < TT * D * M2; it += nth) {
    const int t = it / (D * M2), e = it - t * (D * M2), j = e / M2, F = e - j * M2;
    const int blk = F / D, l = F - blk * D;
    const T want = j == l ? coeff[t * D * M2 + blk * D] : T(0);
    kron_ok = kron_ok && coeff[it] == want;
  }
  for (int it = tid; it < 10 * TT; it += nth) {  // a_p a_q of each t, pairs p <= q
    const int t = it / 10;
    int p, q;
    upper_pair(it - 10 * t, 4, &p, &q);
    kron[it] = acoef[4 * t + p] * acoef[4 * t + q];
  }
  for (int it = tid; it < 2 * M * M; it += nth) {  // J1^T W, J2^T W
    const int w = it / (M * M), e = it - w * (M * M), p = e / M, q = e - p * M;
    const T* Jm = w ? J2 : J1;
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < M; ++r) acc += Jm[r * M + p] * W[r * M + q];
    (w ? Q2 : Q1)[e] = acc;
  }
  const bool is_kron = __syncthreads_and(kron_ok);
  for (int it = tid; it < 3 * M * M; it += nth) {  // J1^T W J1, J1^T W J2, J2^T W J2
    const int w = it / (M * M), e = it - w * (M * M), p = e / M, q = e - p * M;
    const T* Qm = w == 2 ? Q2 : Q1;
    const T* Jm = w == 0 ? J1 : J2;
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < M; ++r) acc += Qm[p * M + r] * Jm[r * M + q];
    (w == 0 ? A11 : w == 1 ? A12 : A22)[e] = acc;
  }

  // the H entry (hp, hq) this thread writes each unit, and where it reads:
  // G's entry, the three blocks of sum_t (a_t a_t^T) (x) G_t, G0's entry
  const int hp = tid / M, hq = tid % M;
  const int h_e = upper_index(hp % D, hq % D, D);
  const int h_pc = upper_index(min(hp, hq) / D, max(hp, hq) / D, 4);
  const int h_po = upper_index(hp / D, 2 + hq / D, 4);
  const int h_pn = upper_index(2 + min(hp, hq) / D, 2 + max(hp, hq) / D, 4);
  const int h_g0 = hp < D && hq < D ? upper_index(hp, hq, D) : -1;
  const T obs_w = *a.obs_w;
  Chunk c1 = next_chunk(cur);
  T obs_rr = T(0);  // this thread's sum of squared hinge residuals of the plan
  T other = T(0);   // this thread's share of the plan's other errors
  for (int step = 0; valid(cur); ++step, cur = c1, c1 = next_chunk(c1)) {
    const size_t bi = cur.bi;
    const int u = cur.u, j0 = cur.j0, kc = chunk_states(cur);
    const bool interval = u < n - 1;
    if (u == 0 && j0 == 0) {  // a new plan
      for (int it = tid; it < M * M; it += nth) nextH[it] = T(0);
      for (int it = tid; it < M; it += nth) nextb[it] = T(0);
      obs_rr = other = T(0);
    }
    // cur has landed; the next chunk (of this plan or the block's next)
    // goes out
    const int buf = step & 1;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (valid(c1)) issue(buf ^ 1, c1);
    __pipeline_commit();
    const T* st = sm + L.stage + buf * L.stage_size;
    const T* k3 = st + L.st_k3;
    const uint8_t* okd = reinterpret_cast<const uint8_t*>(st + L.st_ok);
    if (j0 == 0) {
      for (int it = tid; it < (interval ? 4 * D : 2 * D); it += nth) z[it] = st[L.st_z + it];
    }
    // hinge residuals and J = -g . Jc of every sphere of the chunk, a
    // thread a (state, sphere)
    for (int k = my_k0; k < kc && tid < k_step * S; k += k_step) {
      const int s = my_s, it = k * S + s;
      const T dist = k3[it];
      const T et = eps[s];
      const bool active = okd[it] != 0 && dist <= et;
      const T r = active ? et - dist : T(0);
      const T gx = k3[(Kc + k) * S + s];
      const T gy = k3[(2 * Kc + k) * S + s];
      const T gz = a.gz ? k3[(3 * Kc + k) * S + s] : T(0);
      const T* jc = st + it * 3 * D;
      T* jr = jrow + it * D;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T dot = gx * jc[j] + gy * jc[D + j];
        if (a.gz) dot = dot + gz * jc[2 * D + j];
        jr[j] = active ? -dot : T(0);
      }
      rr[it] = r;
      obs_rr += r * r;
    }
    __syncthreads();
    // each state's G = J^T J (upper triangle) and g = J^T r, two entries
    // of a row a thread; the last M threads take the GP residual
    // r = J1 z_u + J2 z_u+1 with the unit's first chunk
    for (int it = tid; it < kc * NI; it += nth) {
      const int k = it / NI, i = it - k * NI;
      const int j = items[3 * i], l1 = items[3 * i + 1], l2 = items[3 * i + 2];
      const bool two = l2 != 255;
      const T* jr = jrow + k * S * D;
      const T* c1 = l1 < D ? jr + l1 : rr + k * S;
      const T* c2 = !two ? c1 : l2 < D ? jr + l2 : rr + k * S;
      const int s1 = l1 < D ? D : 1, s2 = !two ? s1 : l2 < D ? D : 1;
      T a1 = T(0), a2 = T(0);
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const T x = jr[s * D + j];
        a1 += x * c1[s * s1];
        a2 += x * c2[s * s2];
      }
      T* out = ustore + (j0 + k) * E;
      out[l1 < D ? upper_index(j, l1, D) : P + j] = a1;
      if (two) out[l2 < D ? upper_index(j, l2, D) : P + j] = a2;
    }
    if (j0 == 0 && interval && tid >= nth - M) {
      const int p = tid - (nth - M);
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < M; ++q) acc += J1[p * M + q] * z[q];
#pragma unroll
      for (int q = 0; q < M; ++q) acc += J2[p * M + q] * z[M + q];
      rgp[p] = acc;
    }
    __syncthreads();
    if (j0 + Kc < unit_states(u)) continue;  // the unit has more states

    // general coefficients: GC_t = G_t C_t, a row (t, j) a thread, then
    // the widened block's upper 2 x 2 tiles, the sum over (t, j) split in
    // two halves, each into its own copy
    using V2 = typename Vec2<T>::type;
    if (interval && !is_kron && TT > 0) {
      if (tid < TT * D) {
        const int t = tid / D, j = tid - t * D;
        const T* G = ustore + (1 + t) * E;
        const T* Ct = coeff + t * D * M2;
        T acc[M2];
#pragma unroll
        for (int F = 0; F < M2; ++F) acc[F] = T(0);
#pragma unroll
        for (int l = 0; l < D; ++l) {
          const T gjl = G[upper_index(j, l, D)];
          const V2* c2 = reinterpret_cast<const V2*>(Ct + l * M2);
#pragma unroll
          for (int F = 0; F < M2 / 2; ++F) {
            const V2 c = c2[F];
            acc[2 * F] += gjl * c.x;
            acc[2 * F + 1] += gjl * c.y;
          }
        }
        V2* out = reinterpret_cast<V2*>(GC + tid * M2);
#pragma unroll
        for (int F = 0; F < M2 / 2; ++F) out[F] = V2{acc[2 * F], acc[2 * F + 1]};
      }
      __syncthreads();
      const int half = (TT * D + 1) / 2;
      for (int it = tid; it < 2 * NT; it += nth) {
        const int h2 = it / NT;
        int ta, tc;
        upper_pair(it - h2 * NT, Q, &ta, &tc);
        T h00 = T(0), h01 = T(0), h10 = T(0), h11 = T(0);
        const int tj1 = min(TT * D, (h2 + 1) * half);
#pragma unroll 4
        for (int tj = h2 * half; tj < tj1; ++tj) {
          const V2 cv = reinterpret_cast<const V2*>(coeff + tj * M2)[ta];
          const V2 gv = reinterpret_cast<const V2*>(GC + tj * M2)[tc];
          h00 += cv.x * gv.x;
          h01 += cv.x * gv.y;
          h10 += cv.y * gv.x;
          h11 += cv.y * gv.y;
        }
        T* h = Hf + h2 * M2 * M2 + (2 * ta) * M2 + 2 * tc;
        h[0] = h00;
        h[1] = h01;
        h[M2] = h10;
        h[M2 + 1] = h11;
      }
      __syncthreads();
    }

    // H_diag[u], H_off[u], b[u], each entry a thread; H_diag[u+1]'s and
    // b[u+1]'s share of interval u carried to the next unit. The widened
    // block's entries of an entry (p, q): from the tiles, or (Qc = c I)
    // sum_t a_p' a_q' G_t[j][l], where the three blocks read share G's entry
    const bool start = u == 0, goal = a.goal_prior && u == n - 1, has = interval && TT > 0;
    const T* G0 = ustore;
    const size_t row = bi * n + u;
    if (tid < M * M) {  // M * M <= nth: the entry (hp, hq) of this thread
      const int it = tid, p = hp, q = hq, lo = min(p, q), hi = max(p, q);
      T cur_hf = T(0), off_hf = T(0), next_hf = T(0);
      if (has && is_kron) {
        for (int t = 0; t < TT; ++t) {
          const T g = ustore[(1 + t) * E + h_e];
          cur_hf += kron[10 * t + h_pc] * g;
          off_hf += kron[10 * t + h_po] * g;
          next_hf += kron[10 * t + h_pn] * g;
        }
      } else if (has) {
        auto hf = [&](int r, int c) { return Hf[r * M2 + c] + Hf[M2 * M2 + r * M2 + c]; };
        cur_hf = hf(lo, hi);
        off_hf = hf(p, M + q);
        next_hf = hf(M + lo, M + hi);
      }
      T h = nextH[it];
      if (h_g0 >= 0) h += obs_w * G0[h_g0];
      if (p == q) {
        if (start) h += p < D ? a.pose_w[p] : a.vel_w[p - D];
        if (goal) h += p < D ? a.goal_pose_w[bi * D + p] : a.goal_vel_w[bi * D + p - D];
      }
      if (interval) {
        h += A11[it] + obs_w * cur_hf;
        a.H_off[(bi * (n - 1) + u) * M * M + it] = A12[it] + obs_w * off_hf;
        nextH[it] = A22[it] + obs_w * next_hf;
      }
      a.H_diag[row * M * M + it] = h;
    }
    // b's entries on the threads past H's where there are such
    for (int p = tid - (M * M + M <= nth ? M * M : 0); p < M; p += nth) {
      if (p < 0) continue;
      T bb = nextb[p];
      if (p < D) bb -= obs_w * G0[P + p];
      const T x = z[p];  // z_u = [x_u; v_u]
      if (start) {
        const T r = x - (p < D ? a.start_pose[bi * D + p] : a.start_vel[bi * D + p - D]);
        const T w = p < D ? a.pose_w[p] : a.vel_w[p - D];
        bb -= w * r;
        other += T(0.5) * w * r * r;
      }
      if (goal) {
        const T r = x - (p < D ? a.end_pose[bi * D + p] : a.end_vel[bi * D + p - D]);
        const T w = p < D ? a.goal_pose_w[bi * D + p] : a.goal_vel_w[bi * D + p - D];
        bb -= w * r;
        other += T(0.5) * w * r * r;
      }
      if (interval) {
        // the GP prior: J1^T W r, J2^T W r, and r's share 0.5 r_p (W r)_p
        T j1 = T(0), j2 = T(0), wr = T(0);
#pragma unroll
        for (int q = 0; q < M; ++q) {
          j1 += Q1[p * M + q] * rgp[q];
          j2 += Q2[p * M + q] * rgp[q];
          wr += W[p * M + q] * rgp[q];
        }
        other += T(0.5) * rgp[p] * wr;
        // the widened gradient sum_t C_t^T g_t at p and M + p
        T g1 = T(0), g2 = T(0);
        if (has && is_kron) {
          const int bp = p / D, j = p - bp * D;
          for (int t = 0; t < TT; ++t) {
            const T g = ustore[(1 + t) * E + P + j];
            g1 += acoef[4 * t + bp] * g;
            g2 += acoef[4 * t + 2 + bp] * g;
          }
        } else if (has) {
          for (int t = 0; t < TT; ++t) {
#pragma unroll
            for (int j = 0; j < D; ++j) {
              const T g = ustore[(1 + t) * E + P + j];
              g1 += coeff[(t * D + j) * M2 + p] * g;
              g2 += coeff[(t * D + j) * M2 + M + p] * g;
            }
          }
        }
        bb -= j1 + obs_w * g1;
        nextb[p] = -(j2 + obs_w * g2);
      }
      a.b[row * M + p] = bb;
    }
    __syncthreads();
    if (u < n - 1) continue;
    // the plan's err: the block's sum of both shares
    T e = T(0.5) * obs_w * obs_rr + other;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    if ((tid & 31) == 0) red[tid >> 5] = e;
    __syncthreads();
    if (tid == 0) {
      T tot = T(0);
      for (int w = 0; w < nth / 32; ++w) tot += red[w];
      a.err[bi] = tot;
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const Args<T>& args, const Layout& L, cudaStream_t stream) {
  auto kernel = assemble_vec_kernel<T, D>;
  if (L.total > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
    if (err != cudaSuccess) return err;
  }
  // persistent blocks, as many as fit on the card at once, each walking
  // plans blockIdx.x, + gridDim.x, ...
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, L.total);
  if (err != cudaSuccess) return err;
  const int grid = min(args.B, max(1, per_sm * sms));
  kernel<<<grid, kThreads, L.total, stream>>>(args, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* const* ptrs, int B, int n, int d, int S, int T_,
                   int goal_prior, cudaStream_t stream) {
  Layout L;
  if (!assemble_plan(d, S, T_, sizeof(T), &L) || n < 1 || B < 1)
    return cudaErrorInvalidValue;
  auto c = [&](int i) { return static_cast<const T*>(ptrs[i]); };
  Args<T> args{c(0), c(1), c(2), c(3), c(4), c(5), c(6),
               static_cast<const uint8_t*>(ptrs[7]),
               c(8), c(9), c(10), c(11), c(12), c(13), c(14), c(15), c(16), c(17),
               c(18), c(19), c(20), c(21),
               static_cast<T*>(const_cast<void*>(ptrs[22])),
               static_cast<T*>(const_cast<void*>(ptrs[23])),
               static_cast<T*>(const_cast<void*>(ptrs[24])),
               static_cast<T*>(const_cast<void*>(ptrs[25])),
               B, n, S, T_, goal_prior, 0, 0, 0};
  auto aligned = [&](int i) { return reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0; };
  args.jc_vec = (S * 3 * d * sizeof(T)) % 16 == 0 && aligned(2);
  args.k3_vec = (S * sizeof(T)) % 16 == 0 && aligned(3) && aligned(4) && aligned(5) &&
                (ptrs[6] == nullptr || aligned(6));
  args.ok_vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(ptrs[7]) % 4 == 0;
  switch (d) {
#define GPMP2_ASSEMBLE_CASE(DV) \
  case DV:                      \
    return launch_d<T, DV>(args, L, stream);
    GPMP2_ASSEMBLE_CASE(1) GPMP2_ASSEMBLE_CASE(2) GPMP2_ASSEMBLE_CASE(3)
    GPMP2_ASSEMBLE_CASE(4) GPMP2_ASSEMBLE_CASE(5) GPMP2_ASSEMBLE_CASE(6)
    GPMP2_ASSEMBLE_CASE(7) GPMP2_ASSEMBLE_CASE(8)
#undef GPMP2_ASSEMBLE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// ptrs: the 26 operands in the order of Args (pose, vel, Jc, dist, gx, gy,
// gz or null, ok, eps_total, obs_w, coeff or null, J1, J2, W, start_pose,
// start_vel, pose_w, vel_w, end_pose, end_vel, goal_pose_w, goal_vel_w,
// then the outputs H_diag, H_off, b, err); all contiguous, on the
// stream's device. goal_prior: 0 where an end-effector goal replaces the
// goal prior.
int gpmp2_assemble_vec(const void* const* ptrs, int B, int n, int d, int S, int T,
                       int goal_prior, int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(ptrs, B, n, d, S, T, goal_prior, s)
             : launch<float>(ptrs, B, n, d, S, T, goal_prior, s);
}

// The assembly kernel's launch plan: out = {states a chunk, threads,
// shared bytes}. Returns 0, or cudaErrorInvalidValue outside the built
// range (d in [1, 8], S in [1, 64], T in [0, 16]).
int gpmp2_assemble_vec_plan(int d, int S, int T, int f64, int* out) {
  Layout L;
  if (!assemble_plan(d, S, T, f64 ? sizeof(double) : sizeof(float), &L))
    return cudaErrorInvalidValue;
  out[0] = L.Kc;
  out[1] = kThreads;
  out[2] = static_cast<int>(L.total);
  return 0;
}

}  // extern "C"
