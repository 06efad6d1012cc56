// Voxel-grid unprojection (mvod_unproject_fused) and its gradient with
// respect to the features (mvod_unproject_fused_bwd): the 4-tap bilinear
// gather of every view's feature map into the voxel grid, in the two
// layouts the fusions read:
//   * fused: [B, N, V*C], the views concatenated on channels, with an
//     optional ReLU epilogue; the conv3d U-Net and the ident fusion read
//     it;
//   * per view: [B*V, N, C]; the add, mean and lstm3d fusions read it.
// View row `row` = b * V + view and voxel `vox` land at
// ((b * N + vox) * V + view) * C in the fused layout and at
// (row * N + vox) * C in the per-view one, which is the fused layout with
// B*V batch elements of one view each and no ReLU. So one set of kernels
// serves both, given the views a batch element has (v; the voxel stride
// is v * C) and the ReLU as a template flag; the per-view wrappers
// (kernels/unproject.py::gather, gather_bwd) call the entry points with
// v = 1 and relu = 0.
//
// Replaces the Pallas TPU kernels
// mulit_view_object_detection_tpu/kernels/unproject_pallas.py::
// bilinear_gather_fused (_forward_fused -> _fwd_kernel_fused),
// bilinear_gather (_forward -> _fwd_kernel) and their backward
// (_bwd_rule_fused and _bwd_rule -> _bwd_kernel), which recast the gather
// and its transpose as one-hot [tile, P] x [P, C] matmuls for the MXU
// (O(N*P*C) work). Here the forward is at most 4 loads and 4 multiply-adds
// per output element and the backward at most 4 adds per element of g.
//
// Forward: bound by the bytes it writes (B*V*N*C elements: 16.4 MB in bf16
// at B=1, V=2, C=64, 40^3 voxels, ~5 us at 3.35 TB/s); the feature reads
// hit L2 (a level's maps are at most 4*40*40*64*4 = 1.6 MB). A block owns
// one view row and a tile of 256 voxels: each thread computes one voxel's
// floors, four tap indices and four weights once, into shared memory (the
// coordinates read coalesced), then the block walks the tile, one thread
// per (voxel, 16-byte channel group) making four 16-byte loads and one
// 16-byte store (8 bf16 or 4 float32 channels) into the view's slice of
// the voxel's row. No runtime division: the voxel tile is blockIdx.x, the
// view blockIdx.y, the batch element blockIdx.z, the channel group
// threadIdx.x. Each channel's arithmetic is the plain version's
// (ops/projection.py::bilinear_gather_fused), explicitly rounded:
//   out = t00 + t01 + t10 + t11,  t = value * (weight * valid)
// then the ReLU (acc < 0 -> 0, so NaN stays NaN, as torch.relu), then one
// rounding to the element type; so the kernel equals it bit for bit. The
// scalar variant (vec = 1) is the same kernel for a C that is not a whole
// number of 16-byte groups or a feature or output pointer not aligned to
// 16 bytes (a whole number of groups makes every view offset view * C
// aligned too); the wrapper picks it by shape and alignment before the
// launch.
//
// Backward: bound by reading g, and under the ReLU the saved output
// beside it (2 x 16.4 MB in bf16 at the fused shapes above). A direct
// scatter (one float32 atomicAdd per tap and channel into device memory)
// put every add of a pixel on one address: at P6 (10 x 10) up to 4,720
// taps of a view land on one pixel (chip_smoke.py phase 3,
// adds_per_pixel_max), and it got slower as the map got smaller. Here a
// block owns one view row, one slice of channels and one chunk of voxels;
// each of its lanes (one thread per group of 4 channels) walks its own
// contiguous run of the chunk's voxels in order, keeps one running float32
// sum per tap and channel in registers while the tap stays on one pixel
// (neighbouring voxels of a grid column often share it) and adds the sums
// into the float32 buffer only when the pixel changes, four channels per
// 16-byte atomic (sm_90's float4 atomicAdd). The coarser the map, the more
// taps a sum collects before its add, so the atomics, and their
// contention, shrink most where the map is smallest. The taps are staged
// in shared memory once per voxel. Under the ReLU a lane loads the same 4
// channels of the saved output beside g and sums g only where saved > 0
// (NaN and 0 pass nothing, as _bwd_rule_fused's mask). Accumulating each
// block's slice in shared memory instead was slower on this card: a
// shared-memory float32 atomicAdd compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN) on sm_90a (PERF.md, section 6). The direct scatter
// stays, as its own kernel, for a C that is not a multiple of 4 or a g or
// saved not aligned to 4 elements. Both sum in float32 in no fixed order,
// so the last bits vary run to run; a bfloat16 gradient is cast from the
// float32 buffer once. An invalid tap (out of bounds tap by tap, x in
// (-1, 0) giving tap x0 = -1, the fw == 1 taps kept apart, NaN
// coordinates) adds nothing.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace mvod {
namespace {

constexpr int kTile = kThreads;      // voxels whose taps a block stages
constexpr int kWalkVec = 4;          // channels a backward walk thread owns

// The four taps of the coordinate (x, y), in the order t00, t01, t10, t11,
// with the plain version's rounded operations: flat index into the view's
// map (valid only where ok[k]) and weight (unmasked).
__device__ __forceinline__ void voxel_taps(float x, float y, int fh, int fw,
                                           int (&idx)[4], float (&w)[4],
                                           bool (&ok)[4]) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float lx = __fsub_rn(x, x0);
  const float ly = __fsub_rn(y, y0);
  const float hx = __fsub_rn(1.f, lx);
  const float hy = __fsub_rn(1.f, ly);
  const float x1 = __fadd_rn(x0, 1.f);
  const float y1 = __fadd_rn(y0, 1.f);
  const float ty[4] = {y0, y0, y1, y1};
  const float tx[4] = {x0, x1, x0, x1};
  w[0] = __fmul_rn(hy, hx);
  w[1] = __fmul_rn(hy, lx);
  w[2] = __fmul_rn(ly, hx);
  w[3] = __fmul_rn(ly, lx);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ok[k] = (ty[k] >= 0.f) && (ty[k] < static_cast<float>(fh)) &&
            (tx[k] >= 0.f) && (tx[k] < static_cast<float>(fw));
    idx[k] = ok[k] ? static_cast<int>(ty[k]) * fw + static_cast<int>(tx[k])
                   : 0;
  }
}

// 4 channels of T as floats: 16 bytes of float32 or 8 of bfloat16.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ src, float* f);

template <>
__device__ __forceinline__ void load4<float>(const float* __restrict__ src,
                                             float* f) {
  Vec16<float>::unpack(__ldg(reinterpret_cast<const uint4*>(src)), f);
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ src, float* f) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Forward. Grid (voxel tiles of kTile, views, batch elements); block
// (gx, vy): gx threads over a voxel's C / kVec channel groups, vy voxels
// at a time. Every thread stages one voxel's taps, then the block walks
// the tile.
template <typename T, int kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ feats, const float* __restrict__ xs,
               const float* __restrict__ ys, T* __restrict__ out, int p,
               int fh, int fw, int c, int n) {
  static_assert(kVec == 1 || kVec == Vec16<T>::kN, "16-byte groups only");
  __shared__ int s_idx[4][kTile];
  __shared__ float s_w[4][kTile];
  const long long view = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row = b * gridDim.y + view;
  const long long vc = static_cast<long long>(gridDim.y) * c;
  const int vox0 = blockIdx.x * kTile;
  const int m = min(kTile, n - vox0);
  const int nt = blockDim.x * blockDim.y;
  for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < m; t += nt) {
    const long long at = row * n + vox0 + t;
    int idx[4];
    float w[4];
    bool ok[4];
    voxel_taps(xs[at], ys[at], fh, fw, idx, w, ok);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s_idx[k][t] = idx[k];                       // 0 where invalid
      s_w[k][t] = __fmul_rn(w[k], ok[k] ? 1.f : 0.f);
    }
  }
  __syncthreads();
  const T* fmap = feats + row * p * c;
  T* orow = out + (b * n + vox0) * vc + view * c;
  const int groups = c / kVec;
  for (int i = threadIdx.y; i < m; i += blockDim.y) {
    T* o = orow + i * vc;
    for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
      const int ch = grp * kVec;
      float acc[kVec], v[kVec];
      load_vec<T, kVec>(fmap + static_cast<long long>(s_idx[0][i]) * c + ch,
                        v);
      const float w0 = s_w[0][i];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = __fmul_rn(v[j], w0);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        load_vec<T, kVec>(
            fmap + static_cast<long long>(s_idx[k][i]) * c + ch, v);
        const float wk = s_w[k][i];
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], wk));
      }
      if constexpr (kRelu) {
        // NaN propagates, as in torch.relu
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (acc[j] < 0.f) acc[j] = 0.f;
      }
      store_vec<T, kVec>(o + ch, acc);
    }
  }
}

// Add a lane's 4 running sums for tap pixel q (none if q < 0) into the
// view's dfeats row as one 16-byte float4 atomic (sm_90 and later;
// 16-byte aligned, since C is a multiple of 4 and the buffer is aligned).
__device__ __forceinline__ void flush(float* drow, int q, const float* v,
                                      int c) {
  if (q < 0) return;
  float* a = drow + static_cast<long long>(q) * c;
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(a), make_float4(v[0], v[1], v[2], v[3]));
#else
  for (int i = 0; i < 4; ++i) atomicAdd(a + i, v[i]);
#endif
}

// Backward, walk variant. Grid (voxel chunks, channel slices, view rows);
// block (gx, lanes): gx threads over groups of 4 channels (a slice of
// 4 * gx channels), and lanes, each of which walks its own contiguous run
// of span voxels of the chunk, in order, reading g (and under kRelu the
// saved output) at voxel stride v * C. A lane keeps, per tap, one running
// float32 sum per channel while the tap stays on one pixel (neighbouring
// voxels of a grid column often share it) and adds it into dacc
// [BV, P, C] with a 16-byte device atomic only when the pixel changes.
// The block stages the taps of the next run voxels of every lane in
// shared memory (once per voxel; index -1 where invalid, whose sums are
// never added, so an invalid tap costs no branch).
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bwd_walk_kernel(const T* __restrict__ g, const T* __restrict__ saved,
                    const float* __restrict__ xs,
                    const float* __restrict__ ys, float* __restrict__ dacc,
                    int p, int fh, int fw, int c, int n, int v, int chunk) {
  // voxels whose g a lane loads at once before using it: 4 in float32,
  // where g's bytes bound the kernel, 1 (in a loop unrolled 4 times) in
  // bfloat16, where the registers a batch holds cost more than it saves
  // (measured on the H100, PERF.md section 6)
  constexpr int kBatch = sizeof(T) == 4 ? 4 : 1;
  constexpr int kUnroll = 4 / kBatch;
  // per staged voxel: (index, weight bits) of taps 0..3, read as 2 int4
  __shared__ __align__(16) int2 s_tap[kTile][4];
  const int gx = blockDim.x;
  const int lanes = blockDim.y;
  const int t = threadIdx.y * gx + threadIdx.x;
  const int nt = gx * lanes;
  const int row = blockIdx.z;
  const int b = row / v;                // once a thread
  const long long vc = static_cast<long long>(v) * c;
  const int ch = (blockIdx.y * gx + threadIdx.x) * kWalkVec;
  const bool live = ch < c;
  const int n0 = blockIdx.x * chunk;
  const int n1 = min(n, n0 + chunk);
  const int span = (n1 - n0 + lanes - 1) / lanes;   // voxels a lane walks
  const int run = kTile / lanes;                    // of them staged at once
  const int lane0 = n0 + threadIdx.y * span;        // the lane's first voxel
  float* drow = dacc + static_cast<long long>(row) * p * c + ch;
  // the lane's channels of its view in g's row of voxel 0
  const long long g0 = static_cast<long long>(b) * n * vc +
                       (row - b * v) * c + ch;

  int cur_q[4] = {-1, -1, -1, -1};
  float cur_v[4][kWalkVec] = {};
  for (int step = 0; step < span; step += run) {
    __syncthreads();        // the last step's taps consumed
    for (int s = t; s < lanes * run; s += nt) {
      const int lane = s / run;
      const int j = step + s - lane * run;
      const int vox = n0 + lane * span + j;
      if (j >= span || vox >= n1) continue;
      const long long at = static_cast<long long>(row) * n + vox;
      int idx[4];
      float w[4];
      bool ok[4];
      voxel_taps(xs[at], ys[at], fh, fw, idx, w, ok);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s_tap[s][k] = make_int2(ok[k] ? idx[k] : -1, __float_as_int(w[k]));
    }
    __syncthreads();
    if (!live) continue;
    const int last = min(run, min(span - step, n1 - lane0 - step));
    const long long at0 = g0 + (lane0 + step) * vc;
    const int2(*taps)[4] = s_tap + threadIdx.y * run;
#pragma unroll kUnroll
    for (int r0 = 0; r0 < last; r0 += kBatch) {
      // the batch's g first, so that its loads are in flight together
      float gv[kBatch][kWalkVec];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (r0 + u < last) {
          const long long at = at0 + (r0 + u) * vc;
          load4<T>(g + at, gv[u]);
          if constexpr (kRelu) {
            // the ReLU's mask: only outputs > 0 pass their gradient
            float sv[kWalkVec];
            load4<T>(saved + at, sv);
#pragma unroll
            for (int j = 0; j < kWalkVec; ++j)
              gv[u][j] = sv[j] > 0.f ? gv[u][j] : 0.f;
          }
        }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r0 + u >= last) break;
        const int4* tp = reinterpret_cast<const int4*>(taps[r0 + u]);
        const int4 t01 = tp[0];
        const int4 t23 = tp[1];
        const int qs[4] = {t01.x, t01.z, t23.x, t23.z};
        const float ws[4] = {__int_as_float(t01.y), __int_as_float(t01.w),
                             __int_as_float(t23.y), __int_as_float(t23.w)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (qs[k] != cur_q[k]) {
            flush(drow, cur_q[k], cur_v[k], c);
            cur_q[k] = qs[k];
#pragma unroll
            for (int j = 0; j < kWalkVec; ++j) cur_v[k][j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < kWalkVec; ++j)
            cur_v[k][j] = fmaf(gv[u][j], ws[k], cur_v[k][j]);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < 4; ++k) flush(drow, cur_q[k], cur_v[k], c);
  }
}

// Backward, direct variant (a C that is not a multiple of 4, or g or saved
// not aligned to 4 elements): one thread per element of g, in g's layout
// (channel fastest), four device atomics; with relu, only where saved > 0.
// I is int when every flat index fits, else long long.
template <typename T, typename I>
__global__ void bwd_direct_kernel(const T* __restrict__ g,
                                  const T* __restrict__ saved,
                                  const float* __restrict__ xs,
                                  const float* __restrict__ ys,
                                  float* __restrict__ dacc, int p, int fh,
                                  int fw, int c, int n, int v, int relu,
                                  I total) {
  const I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  // ReLU mask: only outputs > 0 pass their gradient (NaN does not)
  if (relu && !(to_float(saved[i]) > 0.f)) return;
  const int ch = static_cast<int>(i % c);
  const I r = i / c;                       // (b * n + voxel) * v + view
  const I q = r / v;                       // b * n + voxel
  const I b = q / n;
  const I row = b * v + (r - q * v);
  const float gi = to_float(g[i]);
  int idx[4];
  float w[4];
  bool ok[4];
  voxel_taps(xs[row * n + (q - b * n)], ys[row * n + (q - b * n)], fh, fw,
             idx, w, ok);
  float* dmap = dacc + row * p * c + ch;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (ok[k])
      atomicAdd(dmap + static_cast<I>(idx[k]) * c, __fmul_rn(gi, w[k]));
}

template <typename T, int kVec, bool kRelu>
cudaError_t launch_fwd(const T* feats, const float* x, const float* y,
                       T* out, int b, int v, int fh, int fw, int c, int n,
                       int gx, int vy, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, v, b);
  fwd_kernel<T, kVec, kRelu><<<grid, dim3(gx, vy), 0, stream>>>(
      feats, x, y, out, fh * fw, fh, fw, c, n);
  return cudaGetLastError();
}

// b batch elements of v views each.
template <typename T>
cudaError_t fwd(const void* feats, const float* x, const float* y, void* out,
                int b, int v, int fh, int fw, int c, int n, int relu,
                int vec, int gx, int vy, cudaStream_t stream) {
  if (b == 0 || v == 0 || n == 0 || c == 0) return cudaSuccess;
  if (gx < 1 || vy < 1 || gx * vy > kThreads || b > 65535 || v > 65535)
    return cudaErrorInvalidConfiguration;
  const T* f = static_cast<const T*>(feats);
  T* o = static_cast<T*>(out);
  if (vec == 1)
    return relu ? launch_fwd<T, 1, true>(f, x, y, o, b, v, fh, fw, c, n, gx,
                                         vy, stream)
                : launch_fwd<T, 1, false>(f, x, y, o, b, v, fh, fw, c, n,
                                          gx, vy, stream);
  constexpr int kN = Vec16<T>::kN;
  if (vec != kN || c % kN != 0 ||
      (reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(out))
          % 16 != 0)
    return cudaErrorInvalidValue;
  return relu ? launch_fwd<T, kN, true>(f, x, y, o, b, v, fh, fw, c, n, gx,
                                        vy, stream)
              : launch_fwd<T, kN, false>(f, x, y, o, b, v, fh, fw, c, n, gx,
                                         vy, stream);
}

template <typename T>
cudaError_t bwd(const void* g, const void* saved, const float* x,
                const float* y, float* acc, void* dfeats, int b, int v,
                int fh, int fw, int c, int n, int relu, int gx, int lanes,
                int chunk, cudaStream_t stream) {
  const int p = fh * fw;
  const long long bv = static_cast<long long>(b) * v;
  const long long feat_elems = bv * p * c;
  if (relu && saved == nullptr) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(acc, 0, feat_elems * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const T* gt = static_cast<const T*>(g);
  const T* st = static_cast<const T*>(saved);
  const long long total = bv * n * c;
  if (total > 0 && gx == 0) {
    if (total <= INT_MAX && feat_elems <= INT_MAX)
      bwd_direct_kernel<T, int><<<blocks_for(total), kThreads, 0, stream>>>(
          gt, st, x, y, acc, p, fh, fw, c, n, v, relu,
          static_cast<int>(total));
    else
      bwd_direct_kernel<T, long long>
          <<<blocks_for(total), kThreads, 0, stream>>>(
              gt, st, x, y, acc, p, fh, fw, c, n, v, relu, total);
    err = cudaGetLastError();
  } else if (total > 0) {
    const int slices = (c / kWalkVec + gx - 1) / gx;
    if (c % kWalkVec != 0 ||
        (reinterpret_cast<uintptr_t>(g) |
         (relu ? reinterpret_cast<uintptr_t>(saved) : 0)) %
            (kWalkVec * sizeof(T)) ||
        reinterpret_cast<uintptr_t>(acc) % 16)
      return cudaErrorInvalidValue;
    if (gx < 1 || lanes < 1 || gx * lanes > kThreads || chunk < 1 ||
        bv > 65535 || slices > 65535)
      return cudaErrorInvalidConfiguration;
    const dim3 grid((n + chunk - 1) / chunk, slices, bv);
    const dim3 block(gx, lanes);
    if (relu)
      bwd_walk_kernel<T, true><<<grid, block, 0, stream>>>(
          gt, st, x, y, acc, p, fh, fw, c, n, v, chunk);
    else
      bwd_walk_kernel<T, false><<<grid, block, 0, stream>>>(
          gt, st, x, y, acc, p, fh, fw, c, n, v, chunk);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return cast_from_f32<T>(acc, dfeats, feat_elems, stream);
}

}  // namespace
}  // namespace mvod

// feats [B*V, fh*fw, C] (float32 or bfloat16), x, y [B*V, N] float32, out
// [B, N, V*C] in feats' type, relu'd where relu != 0; all contiguous on
// the current device. vec is the channels a thread moves at once (1, or
// 16 bytes' worth: then C must be a multiple of vec and feats and out
// 16-byte aligned); the block is (gx, vy): vy voxels, gx threads over each
// view's C / vec groups. Returns the cudaError_t of the launch (0 =
// success).
extern "C" int mvod_unproject_fused(const void* feats, const float* x,
                                    const float* y, void* out, int b, int v,
                                    int fh, int fw, int c, int n, int relu,
                                    int vec, int gx, int vy, int is_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(mvod::fwd<__nv_bfloat16>(
        feats, x, y, out, b, v, fh, fw, c, n, relu, vec, gx, vy, s));
  return static_cast<int>(mvod::fwd<float>(feats, x, y, out, b, v, fh, fw, c,
                                           n, relu, vec, gx, vy, s));
}

// Gradient of mvod_unproject_fused with respect to feats. g and saved (the
// forward's output; read only when relu != 0, else may be null) are
// [B, N, V*C] in the feature type; x, y [B*V, N] float32; acc a float32
// [B*V, fh*fw, C] buffer that is zeroed and accumulated into; dfeats
// [B*V, fh*fw, C] in the feature type (for float32 it may be acc itself).
// gx = 0 takes the direct scatter; else the walk, with a block of
// (gx, lanes) threads (gx groups of 4 channels; C a multiple of 4, g and
// saved aligned to 4 elements, acc to 16 bytes) and chunk voxels a block.
// All contiguous on the current device. Returns the cudaError_t of the
// launches (0 = success).
extern "C" int mvod_unproject_fused_bwd(const void* g, const void* saved,
                                        const float* x, const float* y,
                                        float* acc, void* dfeats, int b,
                                        int v, int fh, int fw, int c, int n,
                                        int relu, int gx, int lanes,
                                        int chunk, int is_bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(mvod::bwd<__nv_bfloat16>(
        g, saved, x, y, acc, dfeats, b, v, fh, fw, c, n, relu, gx, lanes,
        chunk, s));
  return static_cast<int>(mvod::bwd<float>(g, saved, x, y, acc, dfeats, b, v,
                                           fh, fw, c, n, relu, gx, lanes,
                                           chunk, s));
}
