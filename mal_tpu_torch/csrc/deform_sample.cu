// Multi-scale deformable attention sampling, forward only: kernel K5, and
// below it kernel K5b, the same sampling in a sample-major layout.
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

// Kernel K5b: the same sampling in the sample-major layout of the TPU kernel
// mal_tpu/ops/pallas/deform_sample.py: deform_sample_fused (v2). For every
// (batch x head) group g, tile t, channel c and sample s:
//     out[g, t, c, s] = sum_l aw[g,t,l,s] *
//                       bilinear(vm_l[g, r * ch + c, k], x[g,t,l,s], y[g,t,l,s]),
// summed over the 3 levels and not over points: every sample is a query with
// one point. vm_l (G, h_l * ch, w_l) holds row r of level l in rows
// r * ch .. r * ch + ch; x, y, aw are (G, T, 3, S).
//
// Bound by bytes, like K5: out (G, T, ch, S) is ch times larger than each of
// the three coordinate inputs and is written once. One thread per sample: it
// computes the 12 corner offsets and weights (with aw folded in) once, then
// walks the ch channels, so a warp reads 32 consecutive samples' coordinates
// and writes 32 consecutive floats per channel. The TPU kernel's one-hot
// matmuls and per-row masks are not carried over.
constexpr int kMajorLevels = 3;
constexpr int kMajorThreads = 128;

struct MajorLevels {
  const float* vm[kMajorLevels];
  int h[kMajorLevels];
  int w[kMajorLevels];
};

__global__ void deform_sample_major_kernel(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const float* __restrict__ aw,
                                           float* __restrict__ out,
                                           MajorLevels lv, int T, int S,
                                           int ch) {
  const int chunks = (S + kMajorThreads - 1) / kMajorThreads;
  const int g = blockIdx.y;
  const int t = blockIdx.x / chunks;
  const int s = (blockIdx.x - t * chunks) * kMajorThreads + threadIdx.x;
  if (s >= S) return;
  const size_t gt = static_cast<size_t>(g) * T + t;

  int off[kMajorLevels][4];
  float wgt[kMajorLevels][4];
#pragma unroll
  for (int l = 0; l < kMajorLevels; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const size_t at = (gt * kMajorLevels + l) * S + s;
    const float xs = x[at] * wl - 0.5f;
    const float ys = y[at] * hl - 0.5f;
    const float a = aw[at];
    const float x0f = floorf(xs);
    const float y0f = floorf(ys);
    const float wx1 = xs - x0f;
    const float wy1 = ys - y0f;
    const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), wl + 1.f));
    const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.f), hl + 1.f));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int xi = x0 + (q & 1);
      const int yi = y0 + (q >> 1);
      const bool inside = xi >= 0 && xi < wl && yi >= 0 && yi < hl;
      const float w = ((q >> 1) ? wy1 : 1.f - wy1) * ((q & 1) ? wx1 : 1.f - wx1);
      off[l][q] = inside ? yi * ch * wl + xi : 0;
      wgt[l][q] = inside ? w * a : 0.f;
    }
  }

  float* o = out + gt * ch * S + s;
  for (int c = 0; c < ch; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < kMajorLevels; ++l) {
      const int wl = lv.w[l];
      const float* v = lv.vm[l] +
                       (static_cast<size_t>(g) * lv.h[l] * ch + c) * wl;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc += wgt[l][q] * v[off[l][q]];
    }
    o[static_cast<size_t>(c) * S] = acc;
  }
}

}  // namespace

extern "C" {

// K5b. vm0 / vm1 / vm2: (G, h_l * ch, w_l); x, y, aw: (G, T, 3, S); out:
// (G, T, ch, S), all fp32 on the device. level_h / level_w: 3 host ints each.
// Launches on `stream` and returns cudaGetLastError().
int deform_sample_major_f32(const float* vm0, const float* vm1,
                            const float* vm2, const float* x, const float* y,
                            const float* aw, float* out, const int* level_h,
                            const int* level_w, int G, int T, int S, int ch,
                            void* stream) {
  MajorLevels lv = {{vm0, vm1, vm2}, {}, {}};
  for (int l = 0; l < kMajorLevels; ++l) {
    lv.h[l] = level_h[l];
    lv.w[l] = level_w[l];
  }
  const int chunks = (S + kMajorThreads - 1) / kMajorThreads;
  deform_sample_major_kernel<<<dim3(T * chunks, G), kMajorThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, y, aw, out, lv, T, S, ch);
  return static_cast<int>(cudaGetLastError());
}

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
