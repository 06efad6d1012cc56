// Voxel-grid -> ray-slice reprojection (mvod_reproject_nearest) and its
// gradient with respect to the grid (mvod_reproject_nearest_bwd): for
// every depth sample s of every pixel ray, the voxel of z-slice iz[s]
// nearest to the sample's fractional grid coords (x, y), x and y rounded
// half-to-even (rintf, as jnp.round / torch.round); 0 where the voxel lies
// outside the grid or iz[s] < 0. The grid is [B, nx, ny, nz, C], read and
// written in place (voxel (ix, iy, z) at ((ix * ny + iy) * nz + z) * C);
// the per-sample z indices travel by value in the kernel parameters (no
// device copy, so no host-device synchronisation per call).
//
// Replaces the Pallas TPU kernels
// mulit_view_object_detection_tpu/kernels/reproject_pallas.py::
// zslice_gather (_reproj_forward -> _fwd_kernel) and its backward
// (_reproj_bwd -> _bwd_kernel), which recast the gather and its transpose
// as one-hot [tile, nx*ny] x [nx*ny, C] matmuls per depth sample over a
// z-major copy of the grid, and revisited each z-slice block across the
// consecutive samples that read it. Both functions move bytes and do
// almost no arithmetic, so both are bound by bytes on this card.
//
// Forward: bound by the bytes it writes (B*S_d*S*S*C elements: 4.1 MB in
// bf16 at S_d = 20, S = 40, C = 64). One thread per (batch element,
// sample, pixel, 16-byte channel group: 8 bf16 or 4 float32 channels): it
// rounds x and y once, tests the voxel once and makes one 16-byte load
// and one 16-byte store. Grid (pixel tiles, samples, batch elements),
// block (gx, vy): gx threads over the C / kVec groups, vy pixels; no
// per-element division. The scalar variant (kVec = 1) is the same kernel
// for a C that is not a whole number of 16-byte groups or a grid or output
// pointer not aligned to 16 bytes. A copy: exact in any type.
//
// Backward: bound by the bytes of g it reads and of the gradient grid it
// writes (4.1 + 8.2 MB in bf16 at P4). One pass, in gather form: every
// element of dgrid is written exactly once, in g's type, from a float32
// sum in registers; no float32 scratch grid, no memset, no cast pass, no
// float atomics. Sample s reads only z-slice iz[s], so a block owns one
// (batch element, z-slice, band of `band` consecutive voxels (ix, iy) of
// the slice, slice of channel groups). A slice no sample reads (known
// from iz on the host) stores zeros; the blocks of the slices that are
// read come first in the grid, so that the longer blocks start first.
// For a slice that is read, the block takes the samples with iz[s] == z
// in ascending s and their pixels in chunks of at most `chunk`, and for
// each chunk
//   1. rounds every pixel's (x, y) into a key: its voxel's place in the
//      band, or -1 (outside the grid, outside the band, NaN);
//   2. builds the band's inverse map, voxel -> pixels, in shared memory:
//      each warp counts the keys of its contiguous run of the chunk
//      (__match_any_sync groups equal keys; one lane a group adds the
//      group's size, so no atomics), an exclusive scan over
//      (voxel, warp) gives every warp's place in every bucket, and each
//      warp writes its pixels there in order (its rank in its group). So a
//      bucket lists its pixels in ascending order, deterministically;
//   3. every thread adds, for each of its voxels, the g rows of the
//      bucket's pixels into its float32 sums, in that order.
// The sums start from 0.0f and add in ascending (s, p): the order of the
// plain index_add_ on the CPU (ops/projection.py::zslice_gather_bwd), so
// the kernel equals it bit for bit, and a run equals the next. Each
// thread owns `items` voxels of the band (the block's vy voxel rows, items
// times) and one 16-byte channel group of each, at most kMaxAcc float32
// sums in registers, and rounds and stores them at the end. What bounds
// it on this card is the chain of steps a block runs in turn (key loads,
// counts, scan, placement, then the g rows), not its bytes (PERF.md
// section 6). The scalar variant (kVec = 1) serves a C
// that is not a whole number of 16-byte groups or a g or dgrid not
// aligned to 16 bytes.
// A sample with iz < 0 or a voxel outside the grid adds nothing, so a
// trailing invalid sample cannot touch slice 0 (the hazard
// reproject_pallas.py:57-64 guards against); samples sharing a slice add
// into it in turn.

#include <cstdint>

#include "common.cuh"

namespace mvod {

constexpr int kMaxSamples = 256;   // depth samples a call takes
constexpr int kMaxAcc = 32;        // float32 sums a backward thread keeps
constexpr int kMaxBand = 256;      // voxels a backward block owns
constexpr int kMaxChunk = 4096;    // pixels a backward block maps at once
constexpr int kWarps = kThreads / 32;

namespace {

struct ZIndex {
  int v[kMaxSamples];
};

// The z-slices some sample reads, ascending: n of them.
struct ReadSlices {
  int n;
  int z[kMaxSamples];
};

// Forward. Grid (pixel tiles of vy, samples, batch elements); block
// (gx, vy).
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ grid, const float* __restrict__ xg,
               const float* __restrict__ yg, ZIndex iz, T* __restrict__ out,
               int nx, int ny, int nz, int c, int npix) {
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= npix) return;
  const int s = blockIdx.y;
  const long long b = blockIdx.z;
  const long long q = (b * gridDim.y + s) * npix + p;
  const float rx = rintf(xg[q]);
  const float ry = rintf(yg[q]);
  const int z = iz.v[s];
  const bool ok = z >= 0 && rx >= 0.f && rx < static_cast<float>(nx) &&
                  ry >= 0.f && ry < static_cast<float>(ny);
  const T* src =
      grid + (((b * nx + (ok ? static_cast<long long>(rx) : 0)) * ny +
               (ok ? static_cast<long long>(ry) : 0)) * nz + (ok ? z : 0)) * c;
  T* dst = out + q * c;
  for (int ch = threadIdx.x * kVec; ch < c; ch += blockDim.x * kVec) {
    if constexpr (kVec == 1) {
      *(dst + ch) = ok ? src[ch] : from_float<T>(0.f);
    } else {
      *reinterpret_cast<uint4*>(dst + ch) =
          ok ? __ldg(reinterpret_cast<const uint4*>(src + ch))
             : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Exclusive prefix sum of a[0, n) in place by the whole block (kThreads
// threads, each over a contiguous run); `tot` holds kWarps ints.
__device__ void block_exclusive_scan(int* a, int n, int* tot) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, t * per);
  const int hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += o;
    }
    if (lane < kWarps) tot[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? tot[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

// Backward. Grid (bands * channel slices, z-slices, batch elements), the
// rd.n slices that are read first; a block of kThreads threads, thread t
// on channel group t % gx of the slice and voxel rows t / gx (< vy) of
// the band, `items` (<= kMaxAcc / kVec) times vy apart.
// Dynamic shared memory: keys[chunk], list[chunk], off[band * kWarps],
// tot[kWarps] ints.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const T* __restrict__ g, const float* __restrict__ xg,
               const float* __restrict__ yg, ZIndex iz, ReadSlices rd,
               T* __restrict__ dgrid, int nx, int ny, int nz, int c, int s_d,
               int npix, int gx, int items, int slices, int chunk) {
  extern __shared__ int smem[];
  int* keys = smem;
  int* list = keys + chunk;
  const int vy = kThreads / gx;
  const int band = items * vy;
  int* off = list + chunk;
  int* tot = off + band * kWarps;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tx = t % gx;                  // once a thread
  const int ty = t / gx;
  // blocks y < rd.n take the slices that are read, so that they start
  // first; the others the slices no sample reads, in ascending order
  const bool read = static_cast<int>(blockIdx.y) < rd.n;
  int z = read ? rd.z[blockIdx.y] : static_cast<int>(blockIdx.y) - rd.n;
  for (int i = 0; !read && i < rd.n && rd.z[i] <= z; ++i) ++z;
  const long long b = blockIdx.z;
  const int slice = blockIdx.x % slices;  // once a thread
  const int v0 = (blockIdx.x / slices) * band;
  const int nvb = min(band, nx * ny - v0);
  const int ch = (slice * gx + tx) * kVec;
  const bool live = ty < vy && ch < c;

  constexpr int kItems = kMaxAcc / kVec;
  float acc[kItems][kVec];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[k][j] = 0.f;

  for (int s = 0; read && s < s_d; ++s) {
    if (iz.v[s] != z) continue;           // uniform across the block
    const long long row0 = (b * s_d + s) * npix;
    for (int p0 = 0; p0 < npix; p0 += chunk) {
      const int m = min(chunk, npix - p0);
      // 1. keys; zeroed counts
      for (int j = t; j < m; j += kThreads) {
        const float rx = rintf(xg[row0 + p0 + j]);
        const float ry = rintf(yg[row0 + p0 + j]);
        int key = -1;
        if (rx >= 0.f && rx < static_cast<float>(nx) && ry >= 0.f &&
            ry < static_cast<float>(ny)) {
          const int v = static_cast<int>(rx) * ny + static_cast<int>(ry) - v0;
          if (v >= 0 && v < nvb) key = v;
        }
        keys[j] = key;
      }
      for (int i = t; i < nvb * kWarps; i += kThreads) off[i] = 0;
      __syncthreads();
      // 2. counts of each warp's run, (voxel, warp) offsets, the buckets
      const int per = (m + kWarps - 1) / kWarps;
      const int lo = min(m, warp * per);
      const int hi = min(m, lo + per);
      for (int j0 = lo; j0 < hi; j0 += 32) {
        const int j = j0 + lane;
        const int key = j < hi ? keys[j] : -1;
        const unsigned int peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && lane == __ffs(peers) - 1)
          off[key * kWarps + warp] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();
      block_exclusive_scan(off, nvb * kWarps, tot);
      for (int j0 = lo; j0 < hi; j0 += 32) {
        const int j = j0 + lane;
        const int key = j < hi ? keys[j] : -1;
        const unsigned int peers = __match_any_sync(0xffffffffu, key);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int at = key >= 0 ? off[key * kWarps + warp] + rank : 0;
        __syncwarp();
        if (key >= 0) {
          list[at] = p0 + j;
          if (rank == 0) off[key * kWarps + warp] = at + __popc(peers);
        }
        __syncwarp();
      }
      __syncthreads();
      // 3. each thread's voxels: bucket v is list[off[(v - 1) * kWarps +
      // kWarps - 1], off[v * kWarps + kWarps - 1]), in ascending pixels
      if (live) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int v = ty + k * vy;
          if (k >= items || v >= nvb) break;
          const int end = off[v * kWarps + kWarps - 1];
          for (int i = v > 0 ? off[v * kWarps - 1] : 0; i < end; ++i) {
            float f[kVec];
            load_vec<T, kVec>(g + (row0 + list[i]) * c + ch, f);
#pragma unroll
            for (int j = 0; j < kVec; ++j)
              acc[k][j] = __fadd_rn(acc[k][j], f[j]);
          }
        }
      }
      __syncthreads();                    // before the next chunk's keys
    }
  }
  if (!live) return;
  const long long nxy = static_cast<long long>(nx) * ny;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int v = ty + k * vy;
    if (k >= items || v >= nvb) break;
    store_vec<T, kVec>(dgrid + ((b * nxy + v0 + v) * nz + z) * c + ch,
                       acc[k]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t fwd(const void* grid, const float* xg, const float* yg,
                const int* iz_host, void* out, int b, int nx, int ny, int nz,
                int c, int s_d, int npix, int vec, int gx, int vy,
                cudaStream_t stream) {
  if (s_d > kMaxSamples) return cudaErrorInvalidValue;
  if (b == 0 || s_d == 0 || npix == 0 || c == 0) return cudaSuccess;
  if (gx < 1 || vy < 1 || gx * vy > kThreads || b > 65535)
    return cudaErrorInvalidConfiguration;
  constexpr int kN = Vec16<T>::kN;
  if (vec != 1 && (vec != kN || c % kN != 0 || !aligned16(grid) ||
                   !aligned16(out)))
    return cudaErrorInvalidValue;
  ZIndex iz;
  for (int i = 0; i < s_d; ++i) iz.v[i] = iz_host[i];
  const dim3 blocks((npix + vy - 1) / vy, s_d, b);
  const dim3 block(gx, vy);
  const T* src = static_cast<const T*>(grid);
  T* dst = static_cast<T*>(out);
  if (vec == 1)
    fwd_kernel<T, 1><<<blocks, block, 0, stream>>>(src, xg, yg, iz, dst, nx,
                                                   ny, nz, c, npix);
  else
    fwd_kernel<T, kN><<<blocks, block, 0, stream>>>(src, xg, yg, iz, dst, nx,
                                                    ny, nz, c, npix);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* g, const float* xg, const float* yg,
                const int* iz_host, void* dgrid, int b, int nx, int ny,
                int nz, int c, int s_d, int npix, int vec, int gx, int items,
                int chunk, cudaStream_t stream) {
  if (s_d > kMaxSamples) return cudaErrorInvalidValue;
  if (b == 0 || nx == 0 || ny == 0 || nz == 0 || c == 0) return cudaSuccess;
  constexpr int kN = Vec16<T>::kN;
  if (vec != 1 && (vec != kN || c % kN != 0 || !aligned16(g) ||
                   !aligned16(dgrid)))
    return cudaErrorInvalidValue;
  const int groups = c / vec;
  if (gx < 1 || gx > kThreads || gx > groups || items < 1 ||
      items * vec > kMaxAcc || items * (kThreads / gx) > kMaxBand ||
      chunk < 1 ||
      chunk > kMaxChunk || b > 65535 || nz > 65535 ||
      static_cast<long long>(nx) * ny > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const int band = items * (kThreads / gx);
  const long long bands = (static_cast<long long>(nx) * ny + band - 1) / band;
  const int slices = (groups + gx - 1) / gx;
  if (bands * slices > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ZIndex iz;
  ReadSlices rd{};
  for (int i = 0; i < s_d; ++i) iz.v[i] = iz_host[i];
  for (int zi = 0; zi < nz && rd.n < s_d; ++zi)
    for (int i = 0; i < s_d; ++i)
      if (iz_host[i] == zi) {
        rd.z[rd.n++] = zi;
        break;
      }
  const size_t smem = sizeof(int) * (2 * chunk + band * kWarps + kWarps);
  const dim3 blocks(static_cast<unsigned int>(bands * slices), nz, b);
  const T* src = static_cast<const T*>(g);
  T* dst = static_cast<T*>(dgrid);
  if (vec == 1)
    bwd_kernel<T, 1><<<blocks, kThreads, smem, stream>>>(
        src, xg, yg, iz, rd, dst, nx, ny, nz, c, s_d, npix, gx, items,
        slices, chunk);
  else
    bwd_kernel<T, kN><<<blocks, kThreads, smem, stream>>>(
        src, xg, yg, iz, rd, dst, nx, ny, nz, c, s_d, npix, gx, items,
        slices, chunk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mvod

// grid [B, nx, ny, nz, C] (float32 or bfloat16), xg, yg [B, S_d, npix]
// float32, out [B, S_d, npix, C] in grid's type, all contiguous on the
// current device; iz [S_d] int32 in HOST memory, every entry in [-1, nz),
// S_d <= 256. vec is the channels a thread moves at once (1, or 16 bytes'
// worth: then C must be a multiple of vec and grid and out 16-byte
// aligned); the block is (gx, vy): vy pixels, gx threads over the C / vec
// groups. Returns the cudaError_t of the launch (0 = success).
extern "C" int mvod_reproject_nearest(const void* grid, const float* xg,
                                      const float* yg, const int* iz,
                                      void* out, int b, int nx, int ny,
                                      int nz, int c, int s_d, int npix,
                                      int vec, int gx, int vy, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(mvod::fwd<__nv_bfloat16>(
        grid, xg, yg, iz, out, b, nx, ny, nz, c, s_d, npix, vec, gx, vy,
        st));
  return static_cast<int>(mvod::fwd<float>(grid, xg, yg, iz, out, b, nx, ny,
                                           nz, c, s_d, npix, vec, gx, vy,
                                           st));
}

// Gradient of mvod_reproject_nearest with respect to the grid, written in
// one pass. g [B, S_d, npix, C] in the grid's type; xg, yg [B, S_d, npix]
// float32; iz [S_d] int32 in HOST memory (entries in [-1, nz),
// S_d <= 256); dgrid [B, nx, ny, nz, C] in the grid's type, every element
// written. All device buffers contiguous on the current device. vec as
// for the forward (16 bytes' worth: g and dgrid 16-byte aligned); a block
// owns gx channel groups (of C / vec) and items * (256 / gx) <= 256
// voxels of one z-slice, items * vec <= 32, and maps at most
// chunk <= 4096 pixels at a time. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int mvod_reproject_nearest_bwd(const void* g, const float* xg,
                                          const float* yg, const int* iz,
                                          void* dgrid, int b, int nx, int ny,
                                          int nz, int c, int s_d, int npix,
                                          int vec, int gx, int items,
                                          int chunk, int is_bf16,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(mvod::bwd<__nv_bfloat16>(
        g, xg, yg, iz, dgrid, b, nx, ny, nz, c, s_d, npix, vec, gx, items,
        chunk, st));
  return static_cast<int>(mvod::bwd<float>(g, xg, yg, iz, dgrid, b, nx, ny,
                                           nz, c, s_d, npix, vec, gx, items,
                                           chunk, st));
}
