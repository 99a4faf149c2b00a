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
// stage of the JAX lookup gpmp2_tpu/obstacle/sdf.py:396-489
// (sdf_lookup_components / planar_sdf_lookup_components); this kernel
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
// whole of what the P-kernels tried to reach with DMA descriptors.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float dev_floor(float v) { return floorf(v); }
__device__ __forceinline__ double dev_floor(double v) { return floor(v); }

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

// the K corner values of one packed row
template <typename T, int K>
__device__ __forceinline__ void load_row(const T* __restrict__ row, T* v);

template <>
__device__ __forceinline__ void load_row<float, 8>(const float* __restrict__ row, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <>
__device__ __forceinline__ void load_row<float, 4>(const float* __restrict__ row, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

template <>
__device__ __forceinline__ void load_row<double, 8>(const double* __restrict__ row, double* v) {
  const double2* r = reinterpret_cast<const double2*>(row);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double2 a = __ldg(r + k);
    v[2 * k] = a.x;
    v[2 * k + 1] = a.y;
  }
}

template <>
__device__ __forceinline__ void load_row<double, 4>(const double* __restrict__ row, double* v) {
  const double2* r = reinterpret_cast<const double2*>(row);
  const double2 a = __ldg(r), b = __ldg(r + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// grid = (nz, rows, cols); nz is 1 for DIM == 2
template <int DIM, typename T, bool PACKED>
__global__ void __launch_bounds__(kThreads)
sdf_lookup_kernel(const T* __restrict__ pts, int stride,
                  const T* __restrict__ table, const T* __restrict__ origin,
                  const T* __restrict__ cell, T* __restrict__ out,
                  unsigned char* __restrict__ ok, long long N,
                  long long queries_per_world, int nz, int rows, int cols) {
  constexpr int K = DIM == 3 ? 8 : 4;
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
  if constexpr (PACKED) {
    load_row<T, K>(table + base * K, v);
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

template <int DIM, typename T, bool PACKED>
cudaError_t launch(const void* pts, int stride, const void* table,
                   const void* origin, const void* cell, void* out, void* ok,
                   long long N, long long qpw, int nz, int rows, int cols,
                   cudaStream_t stream) {
  const long long grid = (N + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  sdf_lookup_kernel<DIM, T, PACKED><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(pts), stride, static_cast<const T*>(table),
      static_cast<const T*>(origin), static_cast<const T*>(cell),
      static_cast<T*>(out), static_cast<unsigned char*>(ok), N, qpw, nz,
      rows, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dim, int packed, const void* pts, int stride,
                     const void* table, const void* origin, const void* cell,
                     void* out, void* ok, long long N, long long qpw, int nz,
                     int rows, int cols, cudaStream_t s) {
  if (dim == 3)
    return packed ? launch<3, T, true>(pts, stride, table, origin, cell, out, ok, N, qpw, nz, rows, cols, s)
                  : launch<3, T, false>(pts, stride, table, origin, cell, out, ok, N, qpw, nz, rows, cols, s);
  if (dim == 2)
    return packed ? launch<2, T, true>(pts, stride, table, origin, cell, out, ok, N, qpw, 1, rows, cols, s)
                  : launch<2, T, false>(pts, stride, table, origin, cell, out, ok, N, qpw, 1, rows, cols, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// pts (N, stride) query points, coordinate k of point i at
// pts[i * stride + k]; table: packed (W * cells, 2^dim) rows or the raw
// (W * cells) field; origin (>= dim,), cell (); -> out (dim + 1, N) rows
// dist, gx, gy[, gz], ok (N,) bytes. grid (nz, rows, cols), nz ignored
// for dim 2. All on the stream's device.
int gpmp2_sdf_lookup(const void* pts, int stride, const void* table,
                     const void* origin, const void* cell, void* out,
                     void* ok, long long N, long long queries_per_world,
                     int nz, int rows, int cols, int dim, int packed,
                     int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? dispatch<double>(dim, packed, pts, stride, table, origin, cell,
                                out, ok, N, queries_per_world, nz, rows, cols, s)
             : dispatch<float>(dim, packed, pts, stride, table, origin, cell,
                               out, ok, N, queries_per_world, nz, rows, cols, s);
}

}  // extern "C"
