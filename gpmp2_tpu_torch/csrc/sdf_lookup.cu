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
// The JAX package's opt-in table forms and screens are instantiations of
// the same kernel (template parameters, no runtime branch in the default
// float32 row-packed unscreened code):
//   - narrow 3D rows (S = __half or __nv_bfloat16, pack_sdf(dtype=)):
//     one 16-B uint4 load a row, converted to the query type after it;
//   - the corner-major 2D layout (pack_planar_sdf(corner_major=True)):
//     (W, 4, cells), four scalar loads at stride cells;
//   - the hull screen (SignedDistanceField.screen_boxes): K boxes staged
//     in shared memory, bound = min_k |p - box_k| - sqrt(3) cell, the
//     query screened where bound > max(thresh, 0);
//   - the coarse screen (screen_sdf): one read of the min-pooled coarse
//     table (38^3 x 4 B = 219 KB for a 300^3 field at factor 8, resident
//     in L2), screened where bound > thresh.
//   A screened query writes dist = bound, a zero gradient and its mask,
//   and never reads its row: the GPU's counterpart of the JAX lookup's
//   "index collapsed to row 0". Query i's threshold is thresh[i % S]. The
//   bound is computed without fused multiply-adds, in the plain version's
//   order, so the kernel and its plain version screen the same queries.
//
// Per-problem worlds: query i reads world i / queries_per_world (0: one
// shared world); table offsets are 64-bit.
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

#include <type_traits>

// the hull boxes of a block, staged once; 16-B aligned for either type
extern __shared__ __align__(16) unsigned char screen_smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBoxes = 1024;  // 48 KB of float64 boxes in shared memory

enum Layout { kRaw = 0, kPacked = 1, kCornerMajor = 2 };
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

// the hull screen's bound: min_k |p - box_k| - sqrt(3) cell. The root is
// taken once, of the least square: a correctly rounded square root is
// monotone, so this equals the least of the K roots bit for bit
template <typename T>
__device__ __forceinline__ T hull_bound(const T* __restrict__ boxes, int n_boxes, T px,
                                        T py, T pz, T cs) {
  T best = T(0);
  for (int k = 0; k < n_boxes; ++k) {
    const T* b = boxes + 6 * k;
    const T dx = max_nan(max_nan(b[0] - px, px - b[3]), T(0));
    const T dy = max_nan(max_nan(b[1] - py, py - b[4]), T(0));
    const T dz = max_nan(max_nan(b[2] - pz, pz - b[5]), T(0));
    const T sq = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
    best = k == 0 ? sq : min_nan(best, sq);
  }
  return dev_sqrt(best) - mul_rn(cs, T(1.7320508075688772));
}

// grid = (nz, rows, cols); nz is 1 for DIM == 2
template <int DIM, typename T, typename S, int LAYOUT, int SCREEN>
__global__ void __launch_bounds__(kThreads)
sdf_lookup_kernel(const T* __restrict__ pts, int stride,
                  const S* __restrict__ table, const T* __restrict__ origin,
                  const T* __restrict__ cell, T* __restrict__ out,
                  unsigned char* __restrict__ ok, long long N,
                  long long queries_per_world, int nz, int rows, int cols,
                  Screen<T> screen) {
  constexpr int K = DIM == 3 ? 8 : 4;
  static_assert(SCREEN == kNoScreen || DIM == 3, "screens are 3D only");
  static_assert(LAYOUT != kCornerMajor || DIM == 2, "corner-major is 2D only");
  static_assert(std::is_same<S, T>::value || (DIM == 3 && LAYOUT == kPacked),
                "narrow storage is for packed 3D rows only");
  const T* boxes = nullptr;
  if constexpr (SCREEN == kHull) {
    T* staged = reinterpret_cast<T*>(screen_smem);
    for (int k = threadIdx.x; k < 6 * screen.n_boxes; k += blockDim.x)
      staged[k] = screen.table[k];
    __syncthreads();
    boxes = staged;
  }
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

  if constexpr (SCREEN != kNoScreen) {
    const T thresh = screen.thresh[i % screen.n_thresh];
    T bound;
    bool screened;
    if constexpr (SCREEN == kHull) {
      bound = hull_bound(boxes, screen.n_boxes, p[0], p[1], p[2], cs);
      screened = !(bound <= max_nan(thresh, T(0)));
    } else {
      const T ccell = screen.coarse_cell[0];
      const int cxi = clipped_index((p[0] - origin[0]) / ccell, screen.cc);
      const int cyi = clipped_index((p[1] - origin[1]) / ccell, screen.cr);
      const int czi = clipped_index((p[2] - origin[2]) / ccell, screen.cz);
      bound = __ldg(screen.table + (static_cast<long long>(czi) * screen.cr + cyi) * screen.cc
                    + cxi);
      screened = !(bound <= thresh);
    }
    if (screened) {
      out[i] = bound;
      out[N + i] = T(0);
      out[2 * N + i] = T(0);
      out[3 * N + i] = T(0);
      ok[i] = in ? 1 : 0;
      return;
    }
  }

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

  T dist, g_row, g_col, g_z = T(0);
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
    const T d00 = v[0], d10 = v[1], d01 = v[2], d11 = v[3];
    dist = (1 - fy) * (1 - fx) * d00 + fy * (1 - fx) * d10
         + (1 - fy) * fx * d01 + fy * fx * d11;
    g_row = (1 - fx) * (d10 - d00) + fx * (d11 - d01);
    g_col = (1 - fy) * (d01 - d00) + fy * (d11 - d10);
  }

  out[i] = dist;
  out[N + i] = g_col / cs;
  out[2 * N + i] = g_row / cs;
  if constexpr (DIM == 3) out[3 * N + i] = g_z / cs;
  ok[i] = in ? 1 : 0;
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
};

template <int DIM, typename T, typename S, int LAYOUT, int SCREEN>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const long long grid = (a.N + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  size_t smem = 0;
  if constexpr (SCREEN == kHull) {
    if (a.screen.n_boxes < 1 || a.screen.n_boxes > kMaxBoxes) return cudaErrorInvalidValue;
    smem = sizeof(T) * 6 * a.screen.n_boxes;
  }
  if constexpr (SCREEN != kNoScreen) {
    if (a.screen.n_thresh < 1) return cudaErrorInvalidValue;
  }
  sdf_lookup_kernel<DIM, T, S, LAYOUT, SCREEN>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
          static_cast<const T*>(a.pts), a.stride, static_cast<const S*>(a.table),
          static_cast<const T*>(a.origin), static_cast<const T*>(a.cell),
          static_cast<T*>(a.out), static_cast<unsigned char*>(a.ok), a.N, a.qpw, a.nz,
          a.rows, a.cols, a.screen);
  return cudaGetLastError();
}

// a 3D lookup of storage S and layout LAYOUT, under its screen
template <typename T, typename S, int LAYOUT>
cudaError_t dispatch_screen(int screen, const Args<T>& a, cudaStream_t s) {
  switch (screen) {
    case kNoScreen: return launch<3, T, S, LAYOUT, kNoScreen>(a, s);
    case kHull: return launch<3, T, S, LAYOUT, kHull>(a, s);
    case kCoarse: return launch<3, T, S, LAYOUT, kCoarse>(a, s);
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
    if (layout == kPacked) return launch<2, T, T, kPacked, kNoScreen>(a, s);
    if (layout == kRaw) return launch<2, T, T, kRaw, kNoScreen>(a, s);
    if (layout == kCornerMajor) return launch<2, T, T, kCornerMajor, kNoScreen>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* pts, int stride, const void* table, const void* origin,
        const void* cell, void* out, void* ok, long long N, long long qpw, int nz,
        int rows, int cols, int dim, int layout, int storage, int screen,
        const void* thresh, long long n_thresh, const void* screen_table,
        const void* coarse_cell, int s0, int s1, int s2, cudaStream_t s) {
  Screen<T> sc{static_cast<const T*>(thresh), n_thresh,
               static_cast<const T*>(screen_table), static_cast<const T*>(coarse_cell),
               screen == kHull ? s0 : 0, s0, s1, s2};
  const Args<T> a{pts, stride, table, origin, cell, out, ok, N, qpw,
                  dim == 3 ? nz : 1, rows, cols, sc};
  return dispatch<T>(dim, layout, storage, screen, a, s);
}

}  // namespace

extern "C" {

// pts (N, stride) query points, coordinate k of point i at
// pts[i * stride + k]; table: layout 0 the raw (W * cells) field, 1
// packed (W * cells, 2^dim) rows, 2 corner-major (W, 4, cells) (2D);
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
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (screen != kNoScreen && queries_per_world != 0) return cudaErrorInvalidValue;
  return f64 ? run<double>(pts, stride, table, origin, cell, out, ok, N,
                           queries_per_world, nz, rows, cols, dim, layout, storage,
                           screen, thresh, n_thresh, screen_table, coarse_cell, s0,
                           s1, s2, s)
             : run<float>(pts, stride, table, origin, cell, out, ok, N,
                          queries_per_world, nz, rows, cols, dim, layout, storage,
                          screen, thresh, n_thresh, screen_table, coarse_cell, s0,
                          s1, s2, s);
}

}  // extern "C"
