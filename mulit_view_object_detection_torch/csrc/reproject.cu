// Voxel-grid -> ray-slice reprojection: for every depth sample s of every
// pixel ray, copy the voxel of z-slice iz[s] nearest to the sample's
// fractional grid coords (x, y).
//
// Replaces the Pallas TPU kernel
// mulit_view_object_detection_tpu/kernels/reproject_pallas.py::
// zslice_gather (_fwd_kernel), which recast the gather as a one-hot
// [tile, nx*ny] x [nx*ny, C] matmul per depth sample for the MXU and read
// a z-major copy of the grid. Here each output element is one load and one
// store, so the kernel is bound by the bytes it writes (B*S_d*S*S*C
// elements: 8 MB per call in f32 at S_d = 20, S = 40, C = 64) and reads
// the [B, nx, ny, nz, C] grid in place at ((ix*ny + iy)*nz + iz)*C + c —
// no transpose copy.
//
// Design: one thread per output element (sample, pixel, channel), channel
// fastest, so loads and stores are channel-contiguous. x and y round
// half-to-even (rintf, as jnp.round / torch.round); a voxel outside the
// grid, or a sample with iz < 0, gives 0. Values are copied, so the
// kernel is exact in any type. The per-sample z indices travel by value in
// the kernel parameters (no device copy, so no host-device synchronisation
// per call).
//
// Backward (mvod_reproject_nearest_bwd) replaces the Pallas TPU kernel
// reproject_pallas.py::_bwd_kernel (via _reproj_bwd), which scattered
// W^T g into a z-major [B, nz, nx*ny, C] gradient with one-hot matmuls,
// revisiting each z-slice block across consecutive samples. Here one
// thread per element of g [B, S_d, npix, C] (channel fastest) atomically
// adds its value into the voxel it was read from, in a zeroed float32
// buffer with the grid's own [B, nx, ny, nz, C] layout; a bfloat16
// gradient is cast from it once. A sample with iz < 0 or a voxel outside
// the grid adds nothing, so z-slices no sample touches stay zero and a
// trailing invalid sample cannot touch slice 0 (the hazard
// reproject_pallas.py:57-64 guards against). The function reads g
// (4.1 MB in bf16 at P4, S_d = 20, S = 40, C = 64) and writes the whole
// gradient grid (8.2 MB in bf16), so it is bound by bytes, a few us.

#include <climits>

#include "common.cuh"

namespace mvod {

constexpr int kMaxSamples = 256;

namespace {

struct ZIndex {
  int v[kMaxSamples];
};

// I is the index type: int when every flat index fits, else long long.
template <typename T, typename I>
__global__ void reproject_nearest_kernel(const T* __restrict__ grid,
                                         const float* __restrict__ xg,
                                         const float* __restrict__ yg,
                                         ZIndex iz, T* out, int nx, int ny,
                                         int nz, int c, int s_d, int npix,
                                         I total) {
  const I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ch = static_cast<int>(i % c);
  I r = i / c;
  const I p = r % npix;
  r /= npix;
  const int s = static_cast<int>(r % s_d);
  const I b = r / s_d;

  const I q = (b * s_d + s) * npix + p;
  const float rx = rintf(xg[q]);
  const float ry = rintf(yg[q]);
  const int z = iz.v[s];
  T val = from_float<T>(0.f);
  if (z >= 0 && rx >= 0.f && rx < static_cast<float>(nx) && ry >= 0.f &&
      ry < static_cast<float>(ny)) {
    const I ix = static_cast<I>(rx);
    const I iy = static_cast<I>(ry);
    val = grid[(((b * nx + ix) * ny + iy) * nz + z) * c + ch];
  }
  out[i] = val;
}

template <typename T, typename I>
__global__ void reproject_nearest_bwd_kernel(const T* __restrict__ g,
                                             const float* __restrict__ xg,
                                             const float* __restrict__ yg,
                                             ZIndex iz,
                                             float* __restrict__ dgrid,
                                             int nx, int ny, int nz, int c,
                                             int s_d, int npix, I total) {
  const I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ch = static_cast<int>(i % c);
  I r = i / c;
  const I p = r % npix;
  r /= npix;
  const int s = static_cast<int>(r % s_d);
  const I b = r / s_d;

  const int z = iz.v[s];
  if (z < 0) return;
  const I q = (b * s_d + s) * npix + p;
  const float rx = rintf(xg[q]);
  const float ry = rintf(yg[q]);
  if (!(rx >= 0.f && rx < static_cast<float>(nx) && ry >= 0.f &&
        ry < static_cast<float>(ny)))
    return;
  const I ix = static_cast<I>(rx);
  const I iy = static_cast<I>(ry);
  atomicAdd(dgrid + (((b * nx + ix) * ny + iy) * nz + z) * c + ch,
            to_float(g[i]));
}

template <typename T>
cudaError_t launch(const void* grid, const float* xg, const float* yg,
                   const int* iz_host, void* out, int b, int nx, int ny,
                   int nz, int c, int s_d, int npix, cudaStream_t stream) {
  if (s_d > kMaxSamples) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * s_d * npix * c;
  const long long grid_elems = static_cast<long long>(b) * nx * ny * nz * c;
  if (total == 0) return cudaSuccess;
  ZIndex iz;
  for (int i = 0; i < s_d; ++i) iz.v[i] = iz_host[i];
  const T* g = static_cast<const T*>(grid);
  T* o = static_cast<T*>(out);
  if (total <= INT_MAX && grid_elems <= INT_MAX)
    reproject_nearest_kernel<T, int>
        <<<blocks_for(total), kThreads, 0, stream>>>(
            g, xg, yg, iz, o, nx, ny, nz, c, s_d, npix,
            static_cast<int>(total));
  else
    reproject_nearest_kernel<T, long long>
        <<<blocks_for(total), kThreads, 0, stream>>>(
            g, xg, yg, iz, o, nx, ny, nz, c, s_d, npix, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const float* xg, const float* yg,
                       const int* iz_host, float* acc, void* dgrid, int b,
                       int nx, int ny, int nz, int c, int s_d, int npix,
                       cudaStream_t stream) {
  if (s_d > kMaxSamples) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * s_d * npix * c;
  const long long grid_elems = static_cast<long long>(b) * nx * ny * nz * c;
  cudaError_t err =
      cudaMemsetAsync(acc, 0, grid_elems * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  ZIndex iz;
  for (int i = 0; i < s_d; ++i) iz.v[i] = iz_host[i];
  const T* gt = static_cast<const T*>(g);
  if (total > 0) {
    if (total <= INT_MAX && grid_elems <= INT_MAX)
      reproject_nearest_bwd_kernel<T, int>
          <<<blocks_for(total), kThreads, 0, stream>>>(
              gt, xg, yg, iz, acc, nx, ny, nz, c, s_d, npix,
              static_cast<int>(total));
    else
      reproject_nearest_bwd_kernel<T, long long>
          <<<blocks_for(total), kThreads, 0, stream>>>(
              gt, xg, yg, iz, acc, nx, ny, nz, c, s_d, npix, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cast_from_f32<T>(acc, dgrid, grid_elems, stream);
}

}  // namespace
}  // namespace mvod

// grid [B, nx, ny, nz, C] (float32 or bfloat16), xg, yg [B, S_d, npix]
// float32, out [B, S_d, npix, C] in grid's type, all contiguous on the
// current device; iz [S_d] int32 in HOST memory, every entry in [-1, nz),
// S_d <= 256.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int mvod_reproject_nearest(const void* grid, const float* xg,
                                      const float* yg, const int* iz,
                                      void* out, int b, int nx, int ny,
                                      int nz, int c, int s_d, int npix,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(mvod::launch<__nv_bfloat16>(
        grid, xg, yg, iz, out, b, nx, ny, nz, c, s_d, npix, st));
  return static_cast<int>(mvod::launch<float>(grid, xg, yg, iz, out, b, nx,
                                              ny, nz, c, s_d, npix, st));
}

// Gradient of mvod_reproject_nearest with respect to the grid. g
// [B, S_d, npix, C] in the grid's type; xg, yg [B, S_d, npix] float32; iz
// [S_d] int32 in HOST memory (entries in [-1, nz), S_d <= 256); acc a
// float32 [B, nx, ny, nz, C] buffer that is zeroed and accumulated into;
// dgrid [B, nx, ny, nz, C] in the grid's type (for float32 it may be acc
// itself). All device buffers contiguous on the current device.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int mvod_reproject_nearest_bwd(const void* g, const float* xg,
                                          const float* yg, const int* iz,
                                          float* acc, void* dgrid, int b,
                                          int nx, int ny, int nz, int c,
                                          int s_d, int npix, int is_bf16,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(mvod::launch_bwd<__nv_bfloat16>(
        g, xg, yg, iz, acc, dgrid, b, nx, ny, nz, c, s_d, npix, st));
  return static_cast<int>(mvod::launch_bwd<float>(
      g, xg, yg, iz, acc, dgrid, b, nx, ny, nz, c, s_d, npix, st));
}
