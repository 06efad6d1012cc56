// Voxel-grid unprojection, fused layout (mvod_unproject_fused): a 4-tap
// bilinear gather from every view's feature map into the view-concatenated
// channels-last layout [B, N, V*C] that the conv3d U-Net and the ident
// fusion read, with an optional ReLU epilogue. The per-view layout
// [B*V, N, C] has kernels of its own (unproject_view.cu).
//
// Replaces the Pallas TPU kernel
// mulit_view_object_detection_tpu/kernels/unproject_pallas.py::
// bilinear_gather_fused (_fwd_kernel_fused), which recast the gather as a
// one-hot [tile, P] x [P, C] matmul for the MXU: O(N*P*C) work. Here each
// output element is at most 4 loads and 4 multiply-adds, so the kernel is
// bound by the bytes it writes (B*N*V*C elements; 33 MB per level in f32
// at B=1, V=2, C=64, 40^3 voxels) and by the feature reads, which hit L2
// (a level's maps are at most 2*40*40*64*4 = 0.8 MB).
//
// Design: one thread per output element, channel fastest, so a warp's
// loads and stores are channel-contiguous; the thread index decomposes as
// (b, voxel, view, channel). The arithmetic uses explicitly rounded
// multiplies and adds in the order of the plain torch version
// (ops/projection.py::bilinear_gather_fused):
//   out = t00 + t01 + t10 + t11,  t = value * (weight * valid)
// so that the kernel and the plain version agree bit for bit on the card.
// Taps are tested one by one (an out-of-bounds tap contributes zero even
// when its neighbour is in bounds); the floor is floorf, not truncation,
// so x in (-1, 0) gives tap x0 = -1 (invalid) and x0 + 1 = 0 (valid); at
// fw == 1 the x0+1 and y0+1 taps stay separate taps.
//
// Backward (mvod_unproject_fused_bwd) replaces the Pallas TPU kernel
// unproject_pallas.py::_bwd_kernel, reached from _bwd_rule_fused, which
// computed dfeats = W^T g as a one-hot [P, tile] x [tile, C] matmul per
// voxel tile and accumulated it across tiles in VMEM. Here the scatter is
// direct: one thread per element of g, in the forward's layout (channel
// fastest, so a warp reads g contiguously). Where the saved ReLU output is
// > 0 (the mask of _bwd_rule_fused) it recomputes the forward's four tap
// weights with the same rounded operations and atomically adds g * w into
// a float32 [B*V, fh*fw, C] buffer; a bfloat16 gradient is cast from that
// buffer once, in a second pass. The backward must read g and the saved
// output (2 x 16.4 MB in bf16 at P4, B=1, V=2, C=64, 40^3) and writes a
// small dfeats (0.8 MB at P4), so it is bound by those reads (~10 us at
// 3.35 TB/s); at P6 every tap of a view lands in one of its 100 pixels,
// up to 4,720 on one pixel (chip_smoke.py phase 3, adds_per_pixel_max),
// so same-address atomics there are the expected slow spot. Float atomics
// sum in no fixed order: the result varies run to run in the last bits,
// and is held to the plain version with a tolerance.

#include <climits>

#include "common.cuh"

namespace mvod {
namespace {

template <typename T, typename I>
__device__ __forceinline__ float tap(const T* __restrict__ fmap, float yi,
                                     float xi, float wgt, int fh, int fw,
                                     int c) {
  const bool valid = (yi >= 0.f) && (yi < static_cast<float>(fh)) &&
                     (xi >= 0.f) && (xi < static_cast<float>(fw));
  const I idx = valid ? static_cast<I>(yi) * fw + static_cast<I>(xi) : 0;
  const float w = __fmul_rn(wgt, valid ? 1.f : 0.f);
  return __fmul_rn(to_float(fmap[idx * c]), w);
}

// Where output element i = ((b*N + vox)*V + view)*C + ch reads from: its
// view row bv (b * V + view) and voxel, and its channel.
template <typename I>
__device__ __forceinline__ void decompose(I i, int v, int c, int n, I& bv,
                                          I& vox, int& ch) {
  ch = static_cast<int>(i % c);
  I r = i / c;
  const int view = static_cast<int>(r % v);
  r /= v;
  vox = r % n;
  bv = (r / n) * v + view;
}

// I is the index type: int when every flat index fits, else long long
// (64-bit division and modulo cost several times more instructions).
template <typename T, typename I>
__global__ void unproject_kernel(const T* __restrict__ feats,
                                 const float* __restrict__ xs,
                                 const float* __restrict__ ys,
                                 T* __restrict__ out, int v, int fh, int fw,
                                 int c, int n, int relu, I total) {
  const I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  I bv, vox;
  int ch;
  decompose(i, v, c, n, bv, vox, ch);

  const float x = xs[bv * n + vox];
  const float y = ys[bv * n + vox];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float lx = __fsub_rn(x, x0);
  const float ly = __fsub_rn(y, y0);
  const float hx = __fsub_rn(1.f, lx);
  const float hy = __fsub_rn(1.f, ly);
  const float x1 = __fadd_rn(x0, 1.f);
  const float y1 = __fadd_rn(y0, 1.f);

  const T* fmap = feats + bv * fh * fw * c + ch;
  float acc = tap<T, I>(fmap, y0, x0, __fmul_rn(hy, hx), fh, fw, c);
  acc = __fadd_rn(acc, tap<T, I>(fmap, y0, x1, __fmul_rn(hy, lx), fh, fw, c));
  acc = __fadd_rn(acc, tap<T, I>(fmap, y1, x0, __fmul_rn(ly, hx), fh, fw, c));
  acc = __fadd_rn(acc, tap<T, I>(fmap, y1, x1, __fmul_rn(ly, lx), fh, fw, c));
  // ReLU epilogue; NaN propagates, as in torch.relu
  if (relu && acc < 0.f) acc = 0.f;
  out[i] = from_float<T>(acc);
}

template <typename I>
__device__ __forceinline__ void scatter_tap(float* dmap, float yi, float xi,
                                            float wgt, float gi, int fh,
                                            int fw, int c) {
  if (!((yi >= 0.f) && (yi < static_cast<float>(fh)) && (xi >= 0.f) &&
        (xi < static_cast<float>(fw))))
    return;
  const I idx = static_cast<I>(yi) * fw + static_cast<I>(xi);
  atomicAdd(dmap + idx * c, __fmul_rn(gi, wgt));
}

template <typename T, typename I>
__global__ void unproject_bwd_kernel(const T* __restrict__ g,
                                     const T* __restrict__ saved,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ ys,
                                     float* __restrict__ dfeats, int v,
                                     int fh, int fw, int c, int n, int relu,
                                     I total) {
  const I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  // ReLU mask: only outputs > 0 pass their gradient (NaN does not)
  if (relu && !(to_float(saved[i]) > 0.f)) return;
  const float gi = to_float(g[i]);
  I bv, vox;
  int ch;
  decompose(i, v, c, n, bv, vox, ch);

  const float x = xs[bv * n + vox];
  const float y = ys[bv * n + vox];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float lx = __fsub_rn(x, x0);
  const float ly = __fsub_rn(y, y0);
  const float hx = __fsub_rn(1.f, lx);
  const float hy = __fsub_rn(1.f, ly);
  const float x1 = __fadd_rn(x0, 1.f);
  const float y1 = __fadd_rn(y0, 1.f);

  float* dmap = dfeats + bv * fh * fw * c + ch;
  scatter_tap<I>(dmap, y0, x0, __fmul_rn(hy, hx), gi, fh, fw, c);
  scatter_tap<I>(dmap, y0, x1, __fmul_rn(hy, lx), gi, fh, fw, c);
  scatter_tap<I>(dmap, y1, x0, __fmul_rn(ly, hx), gi, fh, fw, c);
  scatter_tap<I>(dmap, y1, x1, __fmul_rn(ly, lx), gi, fh, fw, c);
}

// b view groups of v views each.
template <typename T>
cudaError_t launch(const void* feats, const float* x, const float* y,
                   void* out, int b, int v, int fh, int fw, int c, int n,
                   int relu, cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * n * v * c;
  const long long feat_elems = static_cast<long long>(b) * v * fh * fw * c;
  if (total == 0) return cudaSuccess;
  const T* f = static_cast<const T*>(feats);
  T* o = static_cast<T*>(out);
  if (total <= INT_MAX && feat_elems <= INT_MAX)
    unproject_kernel<T, int>
        <<<blocks_for(total), kThreads, 0, stream>>>(
            f, x, y, o, v, fh, fw, c, n, relu, static_cast<int>(total));
  else
    unproject_kernel<T, long long>
        <<<blocks_for(total), kThreads, 0, stream>>>(f, x, y, o, v, fh, fw,
                                                     c, n, relu, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* saved, const float* x,
                       const float* y, float* acc, void* dfeats, int b, int v,
                       int fh, int fw, int c, int n, int relu,
                       cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * n * v * c;
  const long long feat_elems = static_cast<long long>(b) * v * fh * fw * c;
  cudaError_t err =
      cudaMemsetAsync(acc, 0, feat_elems * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const T* gt = static_cast<const T*>(g);
  const T* st = static_cast<const T*>(saved);
  if (total > 0) {
    if (total <= INT_MAX && feat_elems <= INT_MAX)
      unproject_bwd_kernel<T, int>
          <<<blocks_for(total), kThreads, 0, stream>>>(
              gt, st, x, y, acc, v, fh, fw, c, n, relu,
              static_cast<int>(total));
    else
      unproject_bwd_kernel<T, long long>
          <<<blocks_for(total), kThreads, 0, stream>>>(
              gt, st, x, y, acc, v, fh, fw, c, n, relu, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cast_from_f32<T>(acc, dfeats, feat_elems, stream);
}

}  // namespace
}  // namespace mvod

// feats [B*V, fh*fw, C] (float32 or bfloat16), x, y [B*V, N] float32,
// out [B, N, V*C] in feats' type; all contiguous on the current device.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int mvod_unproject_fused(const void* feats, const float* x,
                                    const float* y, void* out, int b, int v,
                                    int fh, int fw, int c, int n, int relu,
                                    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(mvod::launch<__nv_bfloat16>(
        feats, x, y, out, b, v, fh, fw, c, n, relu, s));
  return static_cast<int>(
      mvod::launch<float>(feats, x, y, out, b, v, fh, fw, c, n, relu, s));
}

// Gradient of mvod_unproject_fused with respect to feats. g and saved (the
// forward's output; read only when relu != 0, else may be null) are
// [B, N, V*C] in the feature type; x, y [B*V, N] float32; acc a float32
// [B*V, fh*fw, C] buffer that is zeroed and accumulated into; dfeats
// [B*V, fh*fw, C] in the feature type (for float32 it may be acc itself,
// and is then left as is). All contiguous on the current device.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int mvod_unproject_fused_bwd(const void* g, const void* saved,
                                        const float* x, const float* y,
                                        float* acc, void* dfeats, int b,
                                        int v, int fh, int fw, int c, int n,
                                        int relu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(mvod::launch_bwd<__nv_bfloat16>(
        g, saved, x, y, acc, dfeats, b, v, fh, fw, c, n, relu, s));
  return static_cast<int>(mvod::launch_bwd<float>(
      g, saved, x, y, acc, dfeats, b, v, fh, fw, c, n, relu, s));
}
