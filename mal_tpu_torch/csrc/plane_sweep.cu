// Plane-sweep cost volume: per-frame masked L1 feature differences (kernel K1).
//
// Replaces the TPU kernel mal_tpu/ops/pallas/cost_volume_kernel.py:
// plane_sweep_diffs_pallas. For every frame bf, depth plane d and pixel
// (v, u) of the 1/4-resolution feature map it projects
//     x = (d * (M [u, v, 1])_0 + t_0) / (d * (M [u, v, 1])_2 + t_2 + 1e-7)
// (y likewise), bilinearly samples the lookup features there with zeros
// padding, and writes the channel mean of |warped - cur| times the border-2
// masks: sample in [2, w-2] x [2, h-2], output u in [2, w-3], v in [2, h-3].
//
// What bounds it on an H100 at the main-path shape (BF=12, D=96, 48x160,
// C=64, 8.85 M samples): the least DRAM traffic is the two feature maps read
// once (47 MB) and the volume written once (35 MB), about 25 us at 3.35 TB/s;
// the fp32 arithmetic, about 9 operations per channel for each sample inside
// the border masks (6.7 M of them at chip_smoke.py's poses), is about
// 4 GFLOP, about 60 us on the 67 TFLOP/s non-tensor pipes. So the bound is
// the arithmetic, and in practice the gathers: each sample reads 4 corners
// x 256 bytes, which the caches must serve.
//
// Design (a first, simple kernel): 16 threads share one output pixel and
// each holds 4 of its 64 channels, so every corner read is one coalesced
// 256-byte row and the current pixel's features are loaded once into
// registers and reused over 8 depth planes. Where the border masks are 0
// (a third of the samples at the main-path shape) no feature is read at all.
// The channel sum is a 16-lane shuffle reduction. The TPU kernel's trick of
// turning the warp into interpolation matmuls on the MXU is not carried
// over: Hopper gathers directly. Shared-memory staging of the source-row
// band, TMA and wgmma are left for later work.
//
// The projection uses __fmul_rn / __fadd_rn / __fdiv_rn, which the compiler
// never contracts into FMAs, in the operation order of the plain PyTorch
// version (plane_sweep_diffs_reference): both compute the same x and y to
// the bit, so the border tests and floor() can not flip between them.
//
// Kernel K6 is the same kernel with kOcc = true. It replaces the TPU kernel
// plane_sweep_diffs_occ_pallas (DynamicDepth's cv_set_1 volume): the
// occlusion mask occ (BF, h, w) of the lookup frame is warped with the same
// four corner weights, occ_w = ((o00 w00 + o01 w01) + o10 w10) + o11 w11,
// rounded op by op in that order as the plain version
// (plane_sweep_diffs_occ_reference) rounds it, so that the test
// occ_w > pool_th can not flip between them. Where it holds and the frame's
// apply_occ is set, the warped features are all 1.0, and the sample's value
// is mean_c |1 - cur_c|: it depends on the pixel only, so it is reduced once
// per pixel from the registers that hold cur, and such a sample reads no
// feature corner. The TPU kernel carries the mask as channel C+1 of its
// interpolation matmuls; here it is an input of its own, which keeps the
// feature rows 16-byte aligned for the float4 loads.
//
// Bound of K6 at DynamicDepth's shape (BF=14, D=96, 48x128, C=64, 8.26 M
// samples): 22 MB each for cur and lookup, 0.34 MB of mask and a 33 MB
// volume, ~0.023 ms at 3.35 TB/s; ~9 fp32 operations per channel for each
// of the ~5-6 M samples inside the border masks, ~3.4 GFLOP or ~0.05 ms on
// the non-tensor pipes. Operations bound it, as they bound K1.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;           // threads per output pixel
constexpr int kPixelsPerBlock = 8;   // 128 threads per block
constexpr int kPlanesPerBlock = 8;   // depth planes swept by one block
constexpr int kMaxGroups = 4;        // float4 channel groups per lane: C <= 256

// kOcc: K6, with occ (BF, h, w), apply_occ (BF,) and pool_th; K1 ignores them
template <bool kOcc>
__global__ void __launch_bounds__(kLanes * kPixelsPerBlock)
plane_sweep_diffs_kernel(const float* __restrict__ cur,
                         const float* __restrict__ lookup,
                         const float* __restrict__ occ,
                         const float* __restrict__ apply_occ,
                         float pool_th,
                         const float* __restrict__ M,
                         const float* __restrict__ t,
                         const float* __restrict__ bins,
                         float* __restrict__ out,
                         int D, int h, int w, int C) {
  const int lane = threadIdx.x % kLanes;
  const int hw = h * w;
  const int pix = blockIdx.x * kPixelsPerBlock + threadIdx.x / kLanes;
  if (pix >= hw) return;  // the whole 16-lane group leaves together
  // the 16 lanes of this pixel: one half of the warp
  const unsigned group_mask = 0xffffu << (threadIdx.x & 16);

  const int bf = blockIdx.y;
  const int v = pix / w;
  const int u = pix - v * w;
  const float uf = static_cast<float>(u);
  const float vf = static_cast<float>(v);
  const bool inner = u >= 2 && u <= w - 3 && v >= 2 && v <= h - 3;

  const float* m = M + bf * 9;
  const float* tb = t + bf * 3;
  // (m0 * u + m1 * v) + m2, rounded op by op as the plain version does
  const float ax = __fadd_rn(__fadd_rn(__fmul_rn(m[0], uf), __fmul_rn(m[1], vf)), m[2]);
  const float ay = __fadd_rn(__fadd_rn(__fmul_rn(m[3], uf), __fmul_rn(m[4], vf)), m[5]);
  const float az = __fadd_rn(__fadd_rn(__fmul_rn(m[6], uf), __fmul_rn(m[7], vf)), m[8]);

  const int groups = C / 4;
  const size_t frame = static_cast<size_t>(bf) * hw;
  const float4* cur4 = reinterpret_cast<const float4*>(cur + (frame + pix) * C);
  float4 c[kMaxGroups];
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k) {
    const int g = lane + k * kLanes;
    c[k] = g < groups ? cur4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* lk = lookup + frame * C;

  // K6: the value of an occluded sample, mean_c |1 - cur_c|, once per pixel
  const bool occluding = kOcc && apply_occ[bf] > 0.f;
  const float* oc = kOcc ? occ + frame : nullptr;
  float occ_result = 0.f;
  if (occluding) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k) {
      if (lane + k * kLanes < groups) {
        acc += fabsf(1.f - c[k].x);
        acc += fabsf(1.f - c[k].y);
        acc += fabsf(1.f - c[k].z);
        acc += fabsf(1.f - c[k].w);
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(group_mask, acc, off, kLanes);
    occ_result = acc / static_cast<float>(C);
  }

  const int d_end = min(static_cast<int>(blockIdx.z + 1) * kPlanesPerBlock, D);
  for (int d = blockIdx.z * kPlanesPerBlock; d < d_end; ++d) {
    const float dep = bins[d];
    const float xh = __fadd_rn(__fmul_rn(dep, ax), tb[0]);
    const float yh = __fadd_rn(__fmul_rn(dep, ay), tb[1]);
    const float zh = __fadd_rn(__fadd_rn(__fmul_rn(dep, az), tb[2]), 1e-7f);
    const float x = __fdiv_rn(xh, zh);
    const float y = __fdiv_rn(yh, zh);
    const bool edge = x >= 2.f && x <= static_cast<float>(w - 2) &&
                      y >= 2.f && y <= static_cast<float>(h - 2);

    float result = 0.f;
    if (inner && edge) {  // the same for all 16 lanes of the pixel
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float wx1 = __fsub_rn(x, x0);
      const float wx0 = __fsub_rn(1.f, wx1);
      const float wy1 = __fsub_rn(y, y0);
      const float wy0 = __fsub_rn(1.f, wy1);
      const float w00 = __fmul_rn(wx0, wy0);
      const float w01 = __fmul_rn(wx1, wy0);
      const float w10 = __fmul_rn(wx0, wy1);
      const float w11 = __fmul_rn(wx1, wy1);
      // the edge test keeps all four corners inside the image
      const int xi = static_cast<int>(x0);
      const int yi = static_cast<int>(y0);
      if (occluding) {
        const float* o0 = oc + yi * w + xi;
        const float* o1 = o0 + w;
        const float occ_w = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(o0[0], w00), __fmul_rn(o0[1], w01)),
                      __fmul_rn(o1[0], w10)),
            __fmul_rn(o1[1], w11));
        if (occ_w > pool_th) {  // the same for all 16 lanes of the pixel
          if (lane == 0) out[(static_cast<size_t>(bf) * D + d) * hw + pix] = occ_result;
          continue;
        }
      }
      const float4* p00 = reinterpret_cast<const float4*>(
          lk + (static_cast<size_t>(yi) * w + xi) * C);
      const float4* p01 = p00 + groups;
      const float4* p10 = p00 + static_cast<size_t>(w) * groups;
      const float4* p11 = p10 + groups;

      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxGroups; ++k) {
        const int g = lane + k * kLanes;
        if (g < groups) {
          const float4 a = p00[g], b = p01[g], e = p10[g], f = p11[g];
          acc += fabsf(a.x * w00 + b.x * w01 + e.x * w10 + f.x * w11 - c[k].x);
          acc += fabsf(a.y * w00 + b.y * w01 + e.y * w10 + f.y * w11 - c[k].y);
          acc += fabsf(a.z * w00 + b.z * w01 + e.z * w10 + f.z * w11 - c[k].z);
          acc += fabsf(a.w * w00 + b.w * w01 + e.w * w10 + f.w * w11 - c[k].w);
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(group_mask, acc, off, kLanes);
      result = acc / static_cast<float>(C);
    }
    if (lane == 0) out[(static_cast<size_t>(bf) * D + d) * hw + pix] = result;
  }
}

template <bool kOcc>
int launch(const float* cur, const float* lookup, const float* occ,
           const float* apply_occ, float pool_th, const float* M,
           const float* t, const float* bins, float* out, int BF, int D,
           int h, int w, int C, void* stream) {
  const dim3 block(kLanes * kPixelsPerBlock);
  const dim3 grid((h * w + kPixelsPerBlock - 1) / kPixelsPerBlock, BF,
                  (D + kPlanesPerBlock - 1) / kPlanesPerBlock);
  plane_sweep_diffs_kernel<kOcc><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      cur, lookup, occ, apply_occ, pool_th, M, t, bins, out, D, h, w, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1. cur, lookup: (BF, h, w, C) fp32, 16-byte aligned, C % 4 == 0,
// C <= 256; M: (BF, 3, 3); t: (BF, 3); bins: (D,); out: (BF, D, h, w). All
// on the device. Launches on `stream` and returns cudaGetLastError().
int plane_sweep_diffs_f32(const float* cur, const float* lookup,
                          const float* M, const float* t, const float* bins,
                          float* out, int BF, int D, int h, int w, int C,
                          void* stream) {
  return launch<false>(cur, lookup, nullptr, nullptr, 0.f, M, t, bins, out,
                       BF, D, h, w, C, stream);
}

// K6. As K1, plus occ: (BF, h, w) fp32 and apply_occ: (BF,) fp32 on the
// device, and the threshold pool_th.
int plane_sweep_diffs_occ_f32(const float* cur, const float* lookup,
                              const float* occ, const float* apply_occ,
                              float pool_th, const float* M, const float* t,
                              const float* bins, float* out, int BF, int D,
                              int h, int w, int C, void* stream) {
  return launch<true>(cur, lookup, occ, apply_occ, pool_th, M, t, bins, out,
                      BF, D, h, w, C, stream);
}

const char* plane_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
