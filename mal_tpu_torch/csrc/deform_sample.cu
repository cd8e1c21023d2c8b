// Multi-scale deformable attention sampling, forward only (kernel K5).
//
// Replaces the TPU kernel mal_tpu/ops/pallas/deform_sample.py:
// deform_sample_fused_v4 (called through
// mal_tpu/segment/msdeform.py:ms_deform_attn_core_pallas). For every batch
// item b, query q, head h and channel c:
//     out[b, q, h*ch + c] = sum_l sum_p aw[b,q,h,l,p] *
//                           bilinear(value_l[b, :, h, c], loc[b,q,h,l,p]),
// where a location in [0, 1] maps to x * w_l - 0.5 (align_corners=False)
// and a corner outside the level map contributes 0 (zeros padding).
//
// Layouts, with no transposes around the call: value (B, S, heads, ch)
// straight from value_proj, S = sum_l h_l * w_l with the levels one after
// another, row-major; loc (B, Lq, heads, L, P, 2) as (x, y); aw (B, Lq,
// heads, L, P); out (B, Lq, heads * ch), the layout output_proj takes.
//
// What bounds it on an H100 at the main-path shape (B=12, Lq=2520, 8 heads,
// ch=32, levels 6x20 / 12x40 / 24x80, 4 points): the least traffic is value
// (31 MB), loc (23 MB) and aw (12 MB) read once and out (31 MB) written
// once, about 97 MB or 0.029 ms at 3.35 TB/s, against under 1 GFLOP of
// arithmetic. So it is bound by bytes, and in practice by the gathers: each
// sample reads 4 corners of 128 bytes that the caches must serve.
//
// Design (a first, simple kernel, the layout of the original MSDeformAttn
// CUDA im2col kernel, written from the maths): one block per (b, q), one
// thread per (head, channel). The 32 lanes of a warp share one (head,
// sample): they read the sample's location and weight at one address (a
// broadcast) and 32 consecutive channels of each corner, 128 contiguous
// bytes. Out-of-range corners are skipped. The TPU kernel's separable
// one-hot matmuls, query tiles and transposes are not carried over: Hopper
// gathers directly.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__global__ void deform_sample_kernel(const float* __restrict__ value,
                                     const float* __restrict__ loc,
                                     const float* __restrict__ aw,
                                     float* __restrict__ out, Levels lv,
                                     int S, int Lq, int heads, int ch, int L,
                                     int P) {
  const int bq = blockIdx.x;          // b * Lq + q
  const int b = bq / Lq;
  const int h = threadIdx.x / ch;
  const int c = threadIdx.x - h * ch;
  const int LP = L * P;
  const float* locs = loc + (static_cast<size_t>(bq) * heads + h) * LP * 2;
  const float* wts = aw + (static_cast<size_t>(bq) * heads + h) * LP;
  const float* vb = value + static_cast<size_t>(b) * S * heads * ch + h * ch + c;
  const int row = heads * ch;         // floats between two value tokens

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float* vl = vb + static_cast<size_t>(lv.start[l]) * row;
    for (int p = 0; p < P; ++p) {
      const int s = l * P + p;
      const float x = locs[2 * s] * wl - 0.5f;
      const float y = locs[2 * s + 1] * hl - 0.5f;
      const float a = wts[s];
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float wx1 = x - x0f;
      const float wy1 = y - y0f;
      const float wx0 = 1.f - wx1;
      const float wy0 = 1.f - wy1;
      // clamped so that a far-off location converts safely; its corners
      // stay outside the map either way
      const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), wl + 1.f));
      const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.f), hl + 1.f));
      float v = 0.f;
      if (y0 >= 0 && y0 < hl) {
        const float* r = vl + static_cast<size_t>(y0) * wl * row;
        if (x0 >= 0 && x0 < wl) v += wy0 * wx0 * r[x0 * row];
        if (x0 + 1 >= 0 && x0 + 1 < wl) v += wy0 * wx1 * r[(x0 + 1) * row];
      }
      if (y0 + 1 >= 0 && y0 + 1 < hl) {
        const float* r = vl + static_cast<size_t>(y0 + 1) * wl * row;
        if (x0 >= 0 && x0 < wl) v += wy1 * wx0 * r[x0 * row];
        if (x0 + 1 >= 0 && x0 + 1 < wl) v += wy1 * wx1 * r[(x0 + 1) * row];
      }
      acc += a * v;
    }
  }
  out[static_cast<size_t>(bq) * row + threadIdx.x] = acc;
}

}  // namespace

extern "C" {

// value: (B, S, heads, ch); loc: (B, Lq, heads, L, P, 2); aw: (B, Lq, heads,
// L, P); out: (B, Lq, heads * ch), all fp32 on the device. level_h / level_w
// / level_start: L host ints each, L <= 4; heads * ch <= 1024. Launches on
// `stream` and returns cudaGetLastError().
int deform_sample_f32(const float* value, const float* loc, const float* aw,
                      float* out, const int* level_h, const int* level_w,
                      const int* level_start, int B, int S, int Lq, int heads,
                      int ch, int L, int P, void* stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_h[l];
    lv.w[l] = level_w[l];
    lv.start[l] = level_start[l];
  }
  deform_sample_kernel<<<B * Lq, heads * ch, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      value, loc, aw, out, lv, S, Lq, heads, ch, L, P);
  return static_cast<int>(cudaGetLastError());
}

const char* deform_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
