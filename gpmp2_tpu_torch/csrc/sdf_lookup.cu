// K3: SDF lookup (bilinear / trilinear distance, gradient and in-range
// mask) with its corner gather on Hopper.
//
// Replaces the TPU row-gather kernels P1-P9: profile_dma2.py:120,181,
// profile_dma3.py:60, profile_dma4.py:82-146, profile_dma5.py:83,102,158,
// profile_dma6.py:61-166, profile_dma7.py:58, profile_dma8.py:68,146,
// profile_dma9.py:78 and profile_dma_gather.py:214. Each of them computes
// out[q] = table[idx[q]] from a corner-packed SDF table (8 corner values
// per row in 3D, 4 in 2D, or those rows padded to 128), and they differ
// only in how they drive Mosaic's DMA engine. That gather is the middle
// stage of the JAX lookup gpmp2_tpu/obstacle/sdf.py:254-489 (sdf_lookup,
// sdf_lookup_components / planar_sdf_lookup_components); this kernel
// computes the whole lookup, so the gathered rows never reach memory:
//
//   1. cell coordinates x = (p - origin) / cell and the in-range mask;
//   2. the low corner clamped to size - 2 after the float-to-int cast
//      (a NaN coordinate gives ok = false and an in-bounds row);
//   3. the corners: one packed row per query, 32 B (f32, 3D) or 16 B
//      (f32, 2D) read as two float4 loads or one; in f64 the rows are
//      64 B / 32 B, read as double2 loads. Without a packed table the 8
//      (or 4) corners are read from the raw field;
//   4. the interpolant and its gradient in registers, in the arithmetic
//      order of the JAX lookup;
//   5. dist, gx, gy[, gz] in the input type as rows of one (DIM+1, N)
//      output, and ok as one byte per query.
//
// The JAX package's opt-in table forms are instantiations of the same
// kernel (template parameters, no runtime branch in the default float32
// row-packed unscreened code):
//   - narrow 3D rows (S = __half or __nv_bfloat16, pack_sdf(dtype=)):
//     one 16-B uint4 load a row, converted to the query type after it;
//   - the corner-major 2D layout (pack_planar_sdf(corner_major=True)):
//     (W, 4, cells), read by one of two routes (below).
// Its screens (3D, one shared world) are instantiations of a second,
// persistent kernel that shares the lookup (`interpolate`):
//   - the hull screen (SignedDistanceField.screen_boxes): bound = min_k
//     |p - box_k| - sqrt(3) cell, screened where bound > max(thresh, 0);
//   - the coarse screen (screen_sdf): bound = the min-pooled coarse table
//     at the point's coarse cell, screened where bound > thresh.
//   A screened query writes dist = bound, a zero gradient and its mask,
//   and never reads its row: the GPU's counterpart of the JAX lookup's
//   "index collapsed to row 0". Query i's threshold is thresh[i % S]. The
//   bound is computed without fused multiply-adds, in the plain version's
//   order, so the kernel and its plain version screen the same queries.
//
// The persistent screen kernel's parts and what each is for (times, and
// the designs measured and not kept, in PERF.md):
//   - a persistent grid: each thread walks i, i + G, ... over a grid of
//     G threads that fits on the card at once, so a hull-screened block
//     stages its boxes once, not once per 256 queries;
//   - a 32-bit threshold index: no 64-bit i % S a query; each thread adds
//     G % S and subtracts S where it passes it;
//   - few instructions a hull box: each NaN-propagating max / min is one
//     FMNMX.NAN in float32, the box two 16-B broadcast loads from shared
//     memory;
//   - no wait on the point: the next query's point is loaded while the
//     current one is screened, so a coarse-screened thread waits on the
//     coarse value (an L2 hit) and its row only;
//   - one store an output, also in a warp that mixes both paths.
//
// Per-problem worlds: query i reads world i / queries_per_world (0: one
// shared world); table offsets are 64-bit.
//
// The planar lookups (one thread a query, as the 3D default) and what was
// measured of them on an H100 (PERF.md, tools/time_k3_screens.py
// --planar --diagnose): at PointRobot2D's 999,424 queries on the 300^2
// OneObstacle map the row-major lookup takes ~18 us against a ~14 us
// streaming floor (every query at one cell: the points and outputs
// alone). The rest is the rows' L2 traffic: a random 16-B row costs a
// 32-B sector from L2. Several queries a thread made it slower (fewer
// resident threads); a persistent grid with the next point in flight,
// 8-B point loads, cache-streaming hints, the L1 carveout and an L2
// prefetch of the table each gained 2% or less, so it keeps its form.
// A corner-major table costs four sectors a query read in place
// (~37 us), so it has two routes:
//   - interleaved: interleave_corners copies the (W, 4, cells) table into
//     packed (W * cells, 4) rows in a scratch buffer (16 B a cell read,
//     16 B written, in float32), then the row-major lookup reads them. It
//     is launched as a programmatic dependent (PDL), so its blocks start
//     and load their points while the copy runs and wait
//     (griddepcontrol.wait) only before their first row;
//   - direct: four loads at stride cells, where copying the whole table
//     costs more than the sectors it saves.
//   The wrapper chooses (ops/sdf_lookup.py, corner_major_route): the copy
//   moves 8 * itemsize bytes a cell and a launch costs about 4 MB of
//   memory time (~1.3 us); it saves three 32-B sectors, 96 B, a query. So
//   interleaved where 8 * itemsize * W * cells + 4 MB <= 96 * N: at
//   PointRobot2D's 999,424 queries on OneObstacle's 90,000 cells (7 MB
//   against 96 MB) ~19 us instead of ~37; at MultiWorld2D's 270,336
//   queries on 8,192 worlds of 4,096 cells (1.08 GB against 26 MB) direct.
//   Both routes give the bits of the row-major lookup.
//   The planar interpolant spells out its roundings (bilinear_rn), so the
//   bits stay those of the lookup that contracted the same expressions
//   implicitly, whatever the kernel around them.
//
// Query points are read in place with a stride: point i's coordinate k is
// pts[i * stride + k], so kernel K2's (N, S, 3) sphere centres go in as
// they are (stride 3), and a planar lookup reads their x and y.
//
// What bounds it on an H100: bytes. At the WAM main-path shape
// (N = 2048 * 101 * 16 = 3,309,568 queries, f32, 300^3 field) it reads
// 40 MB of centres and at most 106 MB of packed rows (fewer where
// neighbouring queries share cells and L2 serves them), and writes 53 MB
// of outputs and 3.3 MB of masks: ~200 MB, ~60 us at the published
// 3.35 TB/s. One thread per query with neighbouring threads on
// neighbouring queries: the point reads and the output writes coalesce;
// the row reads are random, but each is one 32-B sector, which is the
// whole of what the P-kernels tried to reach with DMA descriptors. A
// narrow row or a screen saves only row bytes, a few percent of the total.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

// a hull-screened block's boxes, staged once; 16-B aligned for either type
extern __shared__ __align__(16) unsigned char screen_smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBoxes = 1024;  // 48 KB of float64 boxes in shared memory
constexpr int kCachedDevices = 64;  // devices whose screened grid size is kept

// kInterleaved: a corner-major table read through packed rows in a scratch
enum Layout { kRaw = 0, kPacked = 1, kCornerMajor = 2, kInterleaved = 3 };
enum ScreenKind { kNoScreen = 0, kHull = 1, kCoarse = 2 };

// the screen's operands; unused (all zero) without a screen
template <typename T>
struct Screen {
  const T* thresh;       // (n_thresh,): query i's threshold is thresh[i % n_thresh]
  long long n_thresh;
  const T* table;        // hull: (n_boxes, 2, 3) [lo; hi]; coarse: (cz, cr, cc)
  const T* coarse_cell;  // () coarse cell size
  int n_boxes, cz, cr, cc;
};

__device__ __forceinline__ float dev_floor(float v) { return floorf(v); }
__device__ __forceinline__ double dev_floor(double v) { return floor(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// single-rounded arithmetic that the compiler may not contract into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// max / min that propagate NaN, like jnp.maximum / jnp.min and torch's
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) { return (a < b || a != a) ? a : b; }

// clamp(v, 0, hi) that propagates NaN, like jnp.clip / torch.clamp
template <typename T>
__device__ __forceinline__ T clamp_nan(T v, T hi) {
  return v < T(0) ? T(0) : (v > hi ? hi : v);
}

// floor(c) cast to int and clamped to [0, size - 2]; c is in [0, size - 1]
// or NaN, and NaN gives 0
template <typename T>
__device__ __forceinline__ int low_corner(T c, int size) {
  if (!(c >= T(1))) return 0;
  const int i = static_cast<int>(dev_floor(c));
  return i < size - 2 ? i : size - 2;
}

// the coarse screen's index: c clipped to [0, size - 1], then truncated;
// NaN gives 0
template <typename T>
__device__ __forceinline__ int clipped_index(T c, int size) {
  const T v = clamp_nan(c, T(size - 1));
  return v >= T(1) ? static_cast<int>(v) : 0;
}

// the K corner values of one packed row, in the query type T
template <typename T, typename S, int K>
struct RowLoader;

template <>
struct RowLoader<float, float, 8> {
  __device__ __forceinline__ static void load(const float* __restrict__ row, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <>
struct RowLoader<float, float, 4> {
  __device__ __forceinline__ static void load(const float* __restrict__ row, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};

template <>
struct RowLoader<double, double, 8> {
  __device__ __forceinline__ static void load(const double* __restrict__ row, double* v) {
    const double2* r = reinterpret_cast<const double2*>(row);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double2 a = __ldg(r + k);
      v[2 * k] = a.x;
      v[2 * k + 1] = a.y;
    }
  }
};

template <>
struct RowLoader<double, double, 4> {
  __device__ __forceinline__ static void load(const double* __restrict__ row, double* v) {
    const double2* r = reinterpret_cast<const double2*>(row);
    const double2 a = __ldg(r), b = __ldg(r + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

__device__ __forceinline__ float2 to_float2(__half2 h) { return __half22float2(h); }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 h) { return __bfloat1622float2(h); }

// a narrow 3D row: 8 x 2 B = one 16-B load, each value converted exactly
template <typename T, typename S>
struct NarrowRowLoader {
  using S2 = typename std::conditional<std::is_same<S, __half>::value, __half2,
                                       __nv_bfloat162>::type;
  __device__ __forceinline__ static void load(const S* __restrict__ row, T* v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row));
    const S2* h = reinterpret_cast<const S2*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = to_float2(h[k]);
      v[2 * k] = static_cast<T>(f.x);
      v[2 * k + 1] = static_cast<T>(f.y);
    }
  }
};

template <> struct RowLoader<float, __half, 8> : NarrowRowLoader<float, __half> {};
template <> struct RowLoader<double, __half, 8> : NarrowRowLoader<double, __half> {};
template <> struct RowLoader<float, __nv_bfloat16, 8> : NarrowRowLoader<float, __nv_bfloat16> {};
template <> struct RowLoader<double, __nv_bfloat16, 8> : NarrowRowLoader<double, __nv_bfloat16> {};

// the planar interpolant and its gradient in grid units from the corners
// d00 d10 d01 d11 (row, col offsets), in the JAX lookup's order with each
// rounding spelled out: every product and difference rounded once, each
// sum of products one fused multiply-add per product after the first
// pair, whose first product is fused (as the compiler contracts these
// expressions), so the bits do not depend on the kernel around them
template <typename T>
__device__ __forceinline__ void bilinear_rn(const T* v, T fx, T fy, T& dist, T& g_row,
                                            T& g_col) {
  const T d00 = v[0], d10 = v[1], d01 = v[2], d11 = v[3];
  const T gx = sub_rn(T(1), fx), gy = sub_rn(T(1), fy);
  dist = fma_rn(mul_rn(fy, fx), d11,
                fma_rn(mul_rn(gy, fx), d01,
                       fma_rn(mul_rn(gy, gx), d00, mul_rn(mul_rn(fy, gx), d10))));
  g_row = fma_rn(gx, sub_rn(d10, d00), mul_rn(fx, sub_rn(d11, d01)));
  g_col = fma_rn(gy, sub_rn(d01, d00), mul_rn(fy, sub_rn(d11, d10)));
}

// the lookup of query i at cell coordinates (x, y, z): the clamped
// coordinates, the low corner, one row (or the corners of the raw field)
// of world i / queries_per_world (0: one shared world), then the
// interpolant and its gradient in grid units
template <int DIM, typename T, typename S, int LAYOUT>
__device__ __forceinline__ void interpolate(const S* __restrict__ table, T x, T y, T z,
                                            int nz, int rows, int cols, long long i,
                                            long long queries_per_world, T& dist,
                                            T& g_row, T& g_col, T& g_z) {
  constexpr int K = DIM == 3 ? 8 : 4;
  const T xc = clamp_nan(x, T(cols - 1));
  const T yc = clamp_nan(y, T(rows - 1));
  const int lci = low_corner(xc, cols);
  const int lri = low_corner(yc, rows);
  const T fx = xc - T(lci);
  const T fy = yc - T(lri);
  T zc = T(0), fz = T(0);
  int lzi = 0;
  if constexpr (DIM == 3) {
    zc = clamp_nan(z, T(nz - 1));
    lzi = low_corner(zc, nz);
    fz = zc - T(lzi);
  }

  const long long cells = static_cast<long long>(nz) * rows * cols;
  const long long world = queries_per_world > 0 ? i / queries_per_world : 0;
  const long long base = world * cells
      + (static_cast<long long>(lzi) * rows + lri) * cols + lci;

  // corner order of the packed rows: d000 d010 d001 d011 d100 d110 d101
  // d111 (z, row, col offsets), the first four alone in 2D
  T v[K];
  if constexpr (LAYOUT == kPacked) {
    RowLoader<T, S, K>::load(table + base * K, v);
  } else if constexpr (LAYOUT == kCornerMajor) {
    // world w's table starts at w * 4 * cells; corner k at k * cells
    const T* c = table + base + 3 * world * cells;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(c + k * cells);
  } else {
    const long long rc = static_cast<long long>(rows) * cols;
    v[0] = __ldg(table + base);
    v[1] = __ldg(table + base + cols);
    v[2] = __ldg(table + base + 1);
    v[3] = __ldg(table + base + cols + 1);
    if constexpr (DIM == 3) {
      v[4] = __ldg(table + base + rc);
      v[5] = __ldg(table + base + rc + cols);
      v[6] = __ldg(table + base + rc + 1);
      v[7] = __ldg(table + base + rc + cols + 1);
    }
  }

  if constexpr (DIM == 3) {
    const T d000 = v[0], d010 = v[1], d001 = v[2], d011 = v[3];
    const T d100 = v[4], d110 = v[5], d101 = v[6], d111 = v[7];
    dist = (1 - fy) * (1 - fx) * (1 - fz) * d000
         + fy * (1 - fx) * (1 - fz) * d010
         + (1 - fy) * fx * (1 - fz) * d001
         + fy * fx * (1 - fz) * d011
         + (1 - fy) * (1 - fx) * fz * d100
         + fy * (1 - fx) * fz * d110
         + (1 - fy) * fx * fz * d101
         + fy * fx * fz * d111;
    g_row = (1 - fx) * (1 - fz) * (d010 - d000)
          + fx * (1 - fz) * (d011 - d001)
          + (1 - fx) * fz * (d110 - d100)
          + fx * fz * (d111 - d101);
    g_col = (1 - fy) * (1 - fz) * (d001 - d000)
          + fy * (1 - fz) * (d011 - d010)
          + (1 - fy) * fz * (d101 - d100)
          + fy * fz * (d111 - d110);
    g_z = (1 - fy) * (1 - fx) * (d100 - d000)
        + fy * (1 - fx) * (d110 - d010)
        + (1 - fy) * fx * (d101 - d001)
        + fy * fx * (d111 - d011);
  } else {
    bilinear_rn(v, fx, fy, dist, g_row, g_col);
  }
}

// the unscreened lookup, one thread per query; grid = (nz, rows, cols),
// nz is 1 for DIM == 2. A planar launch after interleave_corners (PDL)
// waits for it before reading a row; griddepcontrol.wait returns at once
// in any other launch
template <int DIM, typename T, typename S, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
sdf_lookup_kernel(const T* __restrict__ pts, int stride,
                  const S* __restrict__ table, const T* __restrict__ origin,
                  const T* __restrict__ cell, T* __restrict__ out,
                  unsigned char* __restrict__ ok, long long N,
                  long long queries_per_world, int nz, int rows, int cols) {
  static_assert(LAYOUT != kCornerMajor || DIM == 2, "corner-major is 2D only");
  static_assert(std::is_same<S, T>::value || (DIM == 3 && LAYOUT == kPacked),
                "narrow storage is for packed 3D rows only");
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const T cs = cell[0];
  const T* p = pts + i * stride;
  const T x = (p[0] - origin[0]) / cs;
  const T y = (p[1] - origin[1]) / cs;
  T z = T(0);
  if constexpr (DIM == 3) z = (p[2] - origin[2]) / cs;
  bool in = x >= T(0) && x <= T(cols - 1) && y >= T(0) && y <= T(rows - 1);
  if constexpr (DIM == 3) in = in && z >= T(0) && z <= T(nz - 1);
  if constexpr (DIM == 2) asm volatile("griddepcontrol.wait;" ::: "memory");

  T dist, g_row, g_col, g_z = T(0);
  interpolate<DIM, T, S, LAYOUT>(table, x, y, z, nz, rows, cols, i, queries_per_world, dist,
                                 g_row, g_col, g_z);

  out[i] = dist;
  out[N + i] = g_col / cs;
  out[2 * N + i] = g_row / cs;
  if constexpr (DIM == 3) out[3 * N + i] = g_z / cs;
  ok[i] = in ? 1 : 0;
}

// a corner-major table (W, 4, cells) as packed rows (W * cells, 4) in
// `rows`, one cell a thread: four loads at stride cells, each coalesced
// across the warp, and one 16-B store (two in float64). Its dependent
// lookup may start as soon as every block has begun
template <typename T>
__global__ void __launch_bounds__(kThreads)
interleave_corners(const T* __restrict__ table, T* __restrict__ rows, long long total,
                   long long cells) {
  asm volatile("griddepcontrol.launch_dependents;");
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= total) return;
  // cell j of world w starts its corners at w * 4 * cells + j % cells
  const T* c = table + j + 3 * (j / cells) * cells;
  const T v0 = __ldg(c), v1 = __ldg(c + cells), v2 = __ldg(c + 2 * cells),
          v3 = __ldg(c + 3 * cells);
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(rows)[j] = make_float4(v0, v1, v2, v3);
  } else {
    reinterpret_cast<double2*>(rows)[2 * j] = make_double2(v0, v1);
    reinterpret_cast<double2*>(rows)[2 * j + 1] = make_double2(v2, v3);
  }
}

// ---- the screens ------------------------------------------------------------

// max / min that propagate NaN in one instruction (float32: Hopper's
// FMNMX.NAN); float64 keeps the compare-and-select
__device__ __forceinline__ float max_nan1(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan1(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ double max_nan1(double a, double b) { return max_nan(a, b); }
__device__ __forceinline__ double min_nan1(double a, double b) { return min_nan(a, b); }

// one hull box [lo; hi] in shared memory: float32 boxes padded to two
// float4 (lo, 0, hi, 0), float64 boxes as three double2, so a box is two
// or three 16-byte broadcast loads
template <typename T>
struct Box {
  T lx, ly, lz, hx, hy, hz;
};
template <typename T>
__host__ __device__ constexpr int box_stride() { return sizeof(T) == 4 ? 8 : 6; }

__device__ __forceinline__ Box<float> load_box(const float* __restrict__ s, int k) {
  const float4 lo = reinterpret_cast<const float4*>(s)[2 * k];
  const float4 hi = reinterpret_cast<const float4*>(s)[2 * k + 1];
  return {lo.x, lo.y, lo.z, hi.x, hi.y, hi.z};
}
__device__ __forceinline__ Box<double> load_box(const double* __restrict__ s, int k) {
  const double2* d = reinterpret_cast<const double2*>(s) + 3 * k;
  const double2 a = d[0], b = d[1], c = d[2];
  return {a.x, a.y, b.x, b.y, c.x, c.y};
}

// the K boxes (K, 2, 3) into shared memory at box_stride, then the barrier
template <typename T>
__device__ __forceinline__ void stage_boxes(T* dst, const T* __restrict__ src, int n_boxes) {
  constexpr int W = box_stride<T>();
  for (int k = threadIdx.x; k < W * n_boxes; k += blockDim.x) {
    if constexpr (W == 6) {
      dst[k] = src[k];
    } else {
      const int b = k >> 3, c = k & 7;
      dst[k] = (c & 3) == 3 ? T(0) : src[6 * b + 3 * (c >> 2) + (c & 3)];
    }
  }
  __syncthreads();
}

// the least squared distance from p to the K boxes, each square FMA-free
// in the plain version's order. Its root, taken once, equals the least of
// the K roots bit for bit: a correctly rounded square root is monotone
template <typename T>
__device__ __forceinline__ T hull_min_sq(const T* __restrict__ boxes, int n_boxes, T px,
                                         T py, T pz) {
  T best = T(INFINITY);
#pragma unroll 4
  for (int k = 0; k < n_boxes; ++k) {
    const Box<T> b = load_box(boxes, k);
    const T dx = max_nan1(max_nan1(b.lx - px, px - b.hx), T(0));
    const T dy = max_nan1(max_nan1(b.ly - py, py - b.hy), T(0));
    const T dz = max_nan1(max_nan1(b.lz - pz, pz - b.hz), T(0));
    best = min_nan1(best, add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz)));
  }
  return best;
}

template <typename T>
__device__ __forceinline__ void load_point(const T* __restrict__ p, T& x, T& y, T& z) {
  x = __ldg(p);
  y = __ldg(p + 1);
  z = __ldg(p + 2);
}

// a screened 3D lookup of one shared world, persistent: the grid is the
// blocks that fit on the card at once, each thread walks queries i, i + G,
// ... (G the grid's threads) with the next query's point in flight while
// the current one is screened and its row read, and query i's threshold
// index i % S kept by adding G % S. A hull-screened block stages its boxes
// once; the coarse table is read through L2. A screened query writes
// dist = bound, a zero gradient and its mask and reads no row; the rest
// take the unscreened lookup
template <typename T, typename S, int LAYOUT, int SCREEN>
__global__ void __launch_bounds__(kThreads)
sdf_screen_kernel(const T* __restrict__ pts, int stride, const S* __restrict__ table,
                  const T* __restrict__ origin, const T* __restrict__ cell,
                  T* __restrict__ out, unsigned char* __restrict__ ok, long long N, int nz,
                  int rows, int cols, Screen<T> screen) {
  static_assert(SCREEN != kNoScreen, "the unscreened lookup is sdf_lookup_kernel");
  static_assert(std::is_same<S, T>::value || LAYOUT == kPacked,
                "narrow storage is for packed 3D rows only");
  const long long G = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  T px = T(0), py = T(0), pz = T(0);
  if (i < N) load_point(pts + i * stride, px, py, pz);
  T* boxes = reinterpret_cast<T*>(screen_smem);
  if constexpr (SCREEN == kHull) stage_boxes(boxes, screen.table, screen.n_boxes);
  if (i >= N) return;

  const T cs = cell[0];
  const T ox = origin[0], oy = origin[1], oz = origin[2];
  const T hull_margin = mul_rn(cs, T(1.7320508075688772));
  const T ccell = SCREEN == kHull ? T(1) : screen.coarse_cell[0];
  // unsigned: ti + step < 2 * n_thresh <= 2^32 - 2 (launch_screen's limit)
  const unsigned n_thresh = static_cast<unsigned>(screen.n_thresh);
  const unsigned step = static_cast<unsigned>(G % n_thresh);
  unsigned ti = static_cast<unsigned>(i % n_thresh);
  for (;;) {
    const long long next = i + G;
    T qx = T(0), qy = T(0), qz = T(0);
    if (next < N) load_point(pts + next * stride, qx, qy, qz);

    const T x = (px - ox) / cs;
    const T y = (py - oy) / cs;
    const T z = (pz - oz) / cs;
    const bool in = x >= T(0) && x <= T(cols - 1) && y >= T(0) && y <= T(rows - 1)
        && z >= T(0) && z <= T(nz - 1);
    const T thresh = __ldg(screen.thresh + ti);
    T bound;
    bool screened;
    if constexpr (SCREEN == kHull) {
      bound = dev_sqrt(hull_min_sq(boxes, screen.n_boxes, px, py, pz)) - hull_margin;
      screened = !(bound <= max_nan(thresh, T(0)));
    } else {
      const int cxi = clipped_index((px - ox) / ccell, screen.cc);
      const int cyi = clipped_index((py - oy) / ccell, screen.cr);
      const int czi = clipped_index((pz - oz) / ccell, screen.cz);
      const long long c = (static_cast<long long>(czi) * screen.cr + cyi) * screen.cc + cxi;
      bound = __ldg(screen.table + c);
      screened = !(bound <= thresh);
    }

    T dist = bound, g_row = T(0), g_col = T(0), g_z = T(0);
    if (!screened) {
      interpolate<3, T, S, LAYOUT>(table, x, y, z, nz, rows, cols, i, 0, dist, g_row, g_col,
                                   g_z);
      g_col = g_col / cs;
      g_row = g_row / cs;
      g_z = g_z / cs;
    }
    out[i] = dist;
    out[N + i] = g_col;
    out[2 * N + i] = g_row;
    out[3 * N + i] = g_z;
    ok[i] = in ? 1 : 0;

    if (next >= N) break;
    i = next;
    px = qx;
    py = qy;
    pz = qz;
    ti += step;
    if (ti >= n_thresh) ti -= n_thresh;
  }
}

// the launch's operands, passed through the dispatch unchanged
template <typename T>
struct Args {
  const void* pts;
  int stride;
  const void* table;
  const void* origin;
  const void* cell;
  void* out;
  void* ok;
  long long N, qpw;
  int nz, rows, cols;
  Screen<T> screen;
  void* scratch;  // the interleaved route's (W * cells, 4) rows
};

// the unscreened lookup of `table` (default the operands' own); with
// `pdl`, launched as a programmatic dependent of the stream's last kernel
template <int DIM, typename T, typename S, int LAYOUT>
cudaError_t launch(const Args<T>& a, cudaStream_t stream, const void* table = nullptr,
                   bool pdl = false) {
  const long long grid = (a.N + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&config, sdf_lookup_kernel<DIM, T, S, LAYOUT>,
                            static_cast<const T*>(a.pts), a.stride,
                            static_cast<const S*>(table ? table : a.table),
                            static_cast<const T*>(a.origin), static_cast<const T*>(a.cell),
                            static_cast<T*>(a.out), static_cast<unsigned char*>(a.ok), a.N,
                            a.qpw, a.nz, a.rows, a.cols);
}

// a corner-major table by its interleaved route: interleave_corners into
// the scratch rows, then the packed planar lookup on them as its
// programmatic dependent
template <typename T>
cudaError_t launch_interleaved(const Args<T>& a, cudaStream_t stream) {
  const long long cells = static_cast<long long>(a.rows) * a.cols;
  const long long total = (a.qpw > 0 ? a.N / a.qpw : 1) * cells;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (a.scratch == nullptr || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  interleave_corners<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(a.table), static_cast<T*>(a.scratch), total, cells);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch<2, T, T, kPacked>(a, stream, a.scratch, true);
}

// the persistent screened launch: the blocks that fit on each SM with the
// hull's boxes in shared memory, times the SMs, at most one query a thread.
// That count is kept per device and instantiation, keyed by the shared
// memory bytes, so repeated launches of one shape query the device once
template <typename T, typename S, int LAYOUT, int SCREEN>
cudaError_t launch_screen(const Args<T>& a, cudaStream_t stream) {
  const Screen<T>& sc = a.screen;
  if (sc.n_thresh < 1 || sc.n_thresh > 0x7fffffffLL) return cudaErrorInvalidValue;
  size_t smem = 0;
  if constexpr (SCREEN == kHull) {
    if (sc.n_boxes < 1 || sc.n_boxes > kMaxBoxes) return cudaErrorInvalidValue;
    smem = sizeof(T) * box_stride<T>() * sc.n_boxes;
  }
  const auto kernel = sdf_screen_kernel<T, S, LAYOUT, SCREEN>;
  // (smem + 1) << 32 | the blocks that fit, per device; 0 before the first launch
  static std::atomic<unsigned long long> fits[kCachedDevices];
  cudaError_t e = cudaSuccess;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  const unsigned long long key = static_cast<unsigned long long>(smem + 1) << 32;
  unsigned long long entry = dev < kCachedDevices ? fits[dev].load(std::memory_order_relaxed)
                                                  : 0;
  if ((entry & ~0xffffffffULL) != key) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    entry = key | static_cast<unsigned>(per_sm * sms);
    if (dev < kCachedDevices) fits[dev].store(entry, std::memory_order_relaxed);
  }
  const long long need = (a.N + kThreads - 1) / kThreads;
  const long long fit = static_cast<long long>(entry & 0xffffffffULL);
  const unsigned grid = static_cast<unsigned>(need < fit ? need : fit);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.pts), a.stride, static_cast<const S*>(a.table),
      static_cast<const T*>(a.origin), static_cast<const T*>(a.cell),
      static_cast<T*>(a.out), static_cast<unsigned char*>(a.ok), a.N, a.nz, a.rows, a.cols,
      a.screen);
  return cudaGetLastError();
}

// a 3D lookup of storage S and layout LAYOUT, under its screen
template <typename T, typename S, int LAYOUT>
cudaError_t dispatch_screen(int screen, const Args<T>& a, cudaStream_t s) {
  switch (screen) {
    case kNoScreen: return launch<3, T, S, LAYOUT>(a, s);
    case kHull: return launch_screen<T, S, LAYOUT, kHull>(a, s);
    case kCoarse: return launch_screen<T, S, LAYOUT, kCoarse>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int dim, int layout, int storage, int screen, const Args<T>& a,
                     cudaStream_t s) {
  if (dim == 3) {
    if (storage != 0 && layout != kPacked) return cudaErrorInvalidValue;
    if (storage == 1) return dispatch_screen<T, __half, kPacked>(screen, a, s);
    if (storage == 2) return dispatch_screen<T, __nv_bfloat16, kPacked>(screen, a, s);
    if (storage != 0) return cudaErrorInvalidValue;
    if (layout == kPacked) return dispatch_screen<T, T, kPacked>(screen, a, s);
    if (layout == kRaw) return dispatch_screen<T, T, kRaw>(screen, a, s);
    return cudaErrorInvalidValue;
  }
  if (dim == 2 && storage == 0 && screen == kNoScreen) {
    if (layout == kPacked) return launch<2, T, T, kPacked>(a, s);
    if (layout == kRaw) return launch<2, T, T, kRaw>(a, s);
    if (layout == kCornerMajor) return launch<2, T, T, kCornerMajor>(a, s);
    if (layout == kInterleaved) return launch_interleaved<T>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* pts, int stride, const void* table, const void* origin,
        const void* cell, void* out, void* ok, long long N, long long qpw, int nz,
        int rows, int cols, int dim, int layout, int storage, int screen,
        const void* thresh, long long n_thresh, const void* screen_table,
        const void* coarse_cell, int s0, int s1, int s2, void* scratch, cudaStream_t s) {
  Screen<T> sc{static_cast<const T*>(thresh), n_thresh,
               static_cast<const T*>(screen_table), static_cast<const T*>(coarse_cell),
               screen == kHull ? s0 : 0, s0, s1, s2};
  const Args<T> a{pts, stride, table, origin, cell, out, ok, N, qpw,
                  dim == 3 ? nz : 1, rows, cols, sc, scratch};
  return dispatch<T>(dim, layout, storage, screen, a, s);
}

}  // namespace

extern "C" {

// pts (N, stride) query points, coordinate k of point i at
// pts[i * stride + k]; table: layout 0 the raw (W * cells) field, 1
// packed (W * cells, 2^dim) rows, 2 corner-major (W, 4, cells) (2D) read
// directly, 3 the same interleaved first into `scratch` (W * cells, 4),
// 16-B aligned;
// storage 0 the query type, 1 float16, 2 bfloat16 (packed 3D rows);
// origin (>= dim,), cell (); -> out (dim + 1, N) rows dist, gx, gy[, gz],
// ok (N,) bytes. grid (nz, rows, cols), nz ignored for dim 2. screen 0
// none, 1 hull (screen_table (s0, 2, 3) boxes), 2 coarse (screen_table
// (s0, s1, s2), coarse_cell ()), with thresh (n_thresh,); 3D, one shared
// world. All on the stream's device.
int gpmp2_sdf_lookup(const void* pts, int stride, const void* table,
                     const void* origin, const void* cell, void* out,
                     void* ok, long long N, long long queries_per_world,
                     int nz, int rows, int cols, int dim, int layout,
                     int storage, int f64, int screen, const void* thresh,
                     long long n_thresh, const void* screen_table,
                     const void* coarse_cell, int s0, int s1, int s2,
                     void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (screen != kNoScreen && queries_per_world != 0) return cudaErrorInvalidValue;
  return f64 ? run<double>(pts, stride, table, origin, cell, out, ok, N,
                           queries_per_world, nz, rows, cols, dim, layout, storage,
                           screen, thresh, n_thresh, screen_table, coarse_cell, s0,
                           s1, s2, scratch, s)
             : run<float>(pts, stride, table, origin, cell, out, ok, N,
                          queries_per_world, nz, rows, cols, dim, layout, storage,
                          screen, thresh, n_thresh, screen_table, coarse_cell, s0,
                          s1, s2, scratch, s);
}

}  // extern "C"
