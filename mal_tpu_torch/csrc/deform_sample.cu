// Multi-scale deformable attention sampling, forward only: kernel K5, and
// below it kernel K5b, the same sampling in a sample-major layout (its two
// routes and what bounds each are described there).
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
// sample reads 4 corners of 128 bytes. Served from L2 (the value tensor fits
// it, but random locations leave L1 nothing to reuse), those 1.49 GB of
// corners at the main-path shape take ~0.4 ms; served from shared memory,
// whose rate is ~8x L2's, they need ~0.05 ms.
//
// Two kernels, chosen by the wrapper from the shapes:
//
// deform_sample_staged_kernel, where a (batch, head) slice of 8 channels
// fits in shared memory (S x 8 x 4 bytes: 80.6 KB at the main-path shape,
// two blocks an SM; up to 7,264 tokens). A 32-channel slice (322.6 KB) does
// not fit, so the channels are split. A persistent grid walks the (batch,
// head, channel group, query) space in contiguous ranges, so a block stages
// a slice once for all of its queries that the range holds (3,665 units a
// block at the main-path shape):
// - staging: the slice's tokens (32 contiguous bytes each, 1 KB apart in
//   device memory) by cp.async, one commit group per level, so the first
//   round samples level 0 (6x20) while level 2 (24x80) still lands;
// - sampling: a round is 256 consecutive queries, one a thread, which loads
//   its query's locations and weights one level ahead and takes all 8
//   channels, so that a sample's coordinates and corner weights are
//   computed once a block; it reads the 4 corners from shared memory, where
//   a token's 16-byte chunks are XOR-swizzled so that neighbouring tokens
//   fall in distinct banks. A corner outside the map is skipped, as the
//   gather kernel and grid_sample skip it, so a non-finite value there
//   reaches no output. The arithmetic is the gather kernel's, operation for
//   operation, so both give the same bits.
// Sampling, not staging, holds it: at random locations the corners'
// shared-memory reads are random, and the points' scattered loads take the
// L1 one line a lane.
//
// deform_sample_kernel, the gather kernel, for slices that do not fit (or
// channels that are not a multiple of 8): the layout of the original
// MSDeformAttn CUDA im2col kernel, written from the maths: one block per
// (b, q), one thread per (head, channel). The 32 lanes of a warp share one
// (head, sample): they read the sample's location and weight at one address
// (a broadcast) and 32 consecutive channels of each corner, 128 contiguous
// bytes, from L2. Out-of-range corners are skipped.
//
// The TPU kernel's separable one-hot matmuls, query tiles and transposes are
// not carried over: Hopper gathers directly.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

constexpr int kStagedThreads = 256;  // queries a round, one a thread
constexpr int kStagedPoints = 4;     // the most points a level it takes
constexpr int kStagedChannels = 8;   // channels of a staged slice

// one level's sampling locations and weights of one query, in registers
struct Points {
  float x[kStagedPoints];
  float y[kStagedPoints];
  float a[kStagedPoints];
};

__device__ __forceinline__ void load_points(Points& pt,
                                            const float* __restrict__ locs,
                                            const float* __restrict__ wts,
                                            int l, int P) {
#pragma unroll
  for (int p = 0; p < kStagedPoints; ++p) {
    if (p < P) {
      const int s = l * P + p;
      pt.x[p] = __ldg(locs + 2 * s);
      pt.y[p] = __ldg(locs + 2 * s + 1);
      pt.a[p] = __ldg(wts + s);
    }
  }
}

// wait until at most n (0 to 3) of this thread's cp.async groups pend
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// K5 from a slice staged in shared memory: a unit is one (slice, query),
// slice = (b * heads + h) * (ch / 8) + channel group; `units` of them in
// all, this block's a contiguous range.
__global__ void __launch_bounds__(kStagedThreads)
    deform_sample_staged_kernel(const float* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ aw,
                                float* __restrict__ out, Levels lv, int S,
                                int Lq, int heads, int ch, int L, int P,
                                long long units) {
  // (S, 8): chunk c (4 channels) of token t at chunk c ^ ((t / 4) % kNv),
  // so that 8 consecutive tokens cover all 32 banks
  extern __shared__ __align__(16) float slice[];
  constexpr int CG = kStagedChannels;
  constexpr int kNv = CG / 4;  // float4s a token
  const int groups = ch / CG;
  const int LP = L * P;
  const int row = heads * ch;  // floats between two value tokens
  const long long begin = units * blockIdx.x / gridDim.x;
  const long long end = units * (blockIdx.x + 1) / gridDim.x;
  for (long long u = begin; u < end;) {
    const long long sl = u / Lq;
    const long long seg_end = end < (sl + 1) * Lq ? end : (sl + 1) * Lq;
    const int cg = static_cast<int>(sl % groups);
    const int h = static_cast<int>(sl / groups % heads);
    const int b = static_cast<int>(sl / groups / heads);
    __syncthreads();  // every thread is done with the slice before
    const float* vb = value + static_cast<size_t>(b) * S * row + h * ch +
                      cg * CG;
    for (int l = 0; l < L; ++l) {  // one commit group a level
      const int t0 = lv.start[l];
      const int n = lv.h[l] * lv.w[l] * kNv;
      for (int idx = threadIdx.x; idx < n; idx += kStagedThreads) {
        const int t = t0 + idx / kNv;
        const int c = idx % kNv;
        cp_async_16(slice + t * CG + 4 * (c ^ ((t >> 2) & (kNv - 1))),
                    vb + static_cast<size_t>(t) * row + 4 * c, true);
      }
      cp_async_commit();
    }
    bool first = true;
    for (long long r = u; r < seg_end; r += kStagedThreads) {
      const long long uq = r + threadIdx.x;
      const bool valid = uq < seg_end;
      const size_t bqh =
          (static_cast<size_t>(b) * Lq + (uq - sl * Lq)) * heads + h;
      const float* locs = loc + bqh * LP * 2;
      const float* wts = aw + bqh * LP;
      float acc[CG] = {};
      // each level's points are loaded while the level before is sampled
      Points cur, next;
      if (valid) load_points(cur, locs, wts, 0, P);
      for (int l = 0; l < L; ++l) {
        if (valid && l + 1 < L) load_points(next, locs, wts, l + 1, P);
        if (first) {  // level l has landed, for every thread's copies
          cp_async_wait_at_most(L - 1 - l);
          __syncthreads();
        }
        if (valid) {
          const int hl = lv.h[l];
          const int wl = lv.w[l];
          const int start = lv.start[l];
          const float4* vl = reinterpret_cast<const float4*>(slice) +
                             start * kNv;
#pragma unroll
          for (int p = 0; p < kStagedPoints; ++p) {
            if (p >= P) break;
            const float x = cur.x[p] * wl - 0.5f;
            const float y = cur.y[p] * hl - 0.5f;
            const float a = cur.a[p];
            const float x0f = floorf(x);
            const float y0f = floorf(y);
            const float wx1 = x - x0f;
            const float wy1 = y - y0f;
            const float wx0 = 1.f - wx1;
            const float wy0 = 1.f - wy1;
            const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), wl + 1.f));
            const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.f), hl + 1.f));
            float v[CG] = {};
            // the gather kernel's sums, channel by channel
            auto corner = [&](int yi, int xi, float wy, float wx) {
              if (yi < 0 || yi >= hl || xi < 0 || xi >= wl) return;
              const int t = yi * wl + xi;
              const float w = wy * wx;
              const int sw = (start + t) >> 2 & (kNv - 1);
#pragma unroll
              for (int c = 0; c < kNv; ++c) {
                const float4 e = vl[t * kNv + (c ^ sw)];
                v[4 * c] += w * e.x;
                v[4 * c + 1] += w * e.y;
                v[4 * c + 2] += w * e.z;
                v[4 * c + 3] += w * e.w;
              }
            };
            corner(y0, x0, wy0, wx0);
            corner(y0, x0 + 1, wy0, wx1);
            corner(y0 + 1, x0, wy1, wx0);
            corner(y0 + 1, x0 + 1, wy1, wx1);
#pragma unroll
            for (int c = 0; c < CG; ++c) acc[c] += a * v[c];
          }
        }
        cur = next;
      }
      first = false;
      if (valid) {
        float4* o = reinterpret_cast<float4*>(out + bqh * ch + cg * CG);
#pragma unroll
        for (int c = 0; c < kNv; ++c)
          o[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2],
                             acc[4 * c + 3]);
      }
    }
    u = seg_end;
  }
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
// What bounds it on an H100 at the pixel decoder's shapes (96 groups of 32
// channels, levels 6x20 / 12x40 / 24x80, 5 tiles of 2048 samples): values
// (31 MB), coordinates and weights (35 MB) read once and out (126 MB)
// written once, 0.057 ms at 3.35 TB/s, against ~1 GFLOP. So it is bound by
// bytes, and in practice by the corner reads: 2.9 M sample-levels x 4
// corners x 32 channels, random 4-byte reads.
//
// Two kernels, chosen by the wrapper (ops/cuda/deform_sample.py:
// major_staged_channels):
//
// deform_sample_major_staged_kernel ("staged"), where a group's slice of 8
// channels fits in a block's shared memory (tokens x 32 bytes: 80.6 KB at
// the shapes above, two blocks an SM; up to 7,264 tokens) and ch is a
// multiple of 8. A persistent grid walks the (group, channel slice, sample)
// space in contiguous ranges, the 4 slices of a group next to each other,
// so that blocks working at once share a group and the coordinates' second
// to fourth reads come from L2. Per slice:
// - staging, transposed on the way in: the global layout is channel-major
//   (a channel's row of w_l floats contiguous), the shared one token-major
//   (8 channels, 32 bytes a token, so that a corner is two 16-byte reads,
//   its chunks XOR-swizzled by (token / 4) % 2 as in K5's staged kernel,
//   where the 32 lanes' random corners then spread over all 8 bank quads).
//   cp.async cannot transpose, so a thread loads through registers, 8 loads
//   in flight: 4 consecutive tokens of one channel as a float4 where a
//   level's rows are 16-byte aligned, 4-byte values elsewhere, and stores
//   them with every lane of the warp in its own bank;
// - sampling: one sample a thread, 256 consecutive samples a round (their
//   coordinates are coalesced reads, loaded a round ahead); each level's 4
//   corner offsets and weights (aw folded in) are computed once for all 8
//   channels, the corners read from shared memory, and the 8 channels
//   written to out (G, T, ch, S) as 8 coalesced rows. The arithmetic is the
//   gather kernel's, operation for operation, so both give the same bits.
// What holds it, reckoned from the code and not measured: the corners'
// shared-memory reads at random tokens.
//
// deform_sample_major_kernel ("gather"), where a slice does not fit or ch
// is not a multiple of 8: one thread per sample computes the 12 corner
// offsets and weights once, then walks the ch channels, reading each corner
// from L2 as a scattered 4-byte load (lanes at random samples touch
// distinct 32-byte sectors), so that a warp writes 32 consecutive floats
// per channel.
//
// The TPU kernel's one-hot matmuls and per-row masks are not carried over.
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

constexpr int kMajorStagedThreads = 256;  // samples a round, one a thread
constexpr int kMajorChannels = 8;         // channels of a staged slice
constexpr int kStageBatch = 8;            // loads a thread has in flight

// Store value `v` of channel c, token t into the staged slice (tokens, 8):
// chunk c / 4 of token t sits at chunk (c / 4) ^ ((t / 4) % 2).
__device__ __forceinline__ void put_staged(float* slice, int t, int c,
                                           float v) {
  slice[t * kMajorChannels + 4 * ((c >> 2) ^ ((t >> 2) & 1)) + (c & 3)] = v;
}

// Stage one level's 8-channel slice, transposed from channel-major rows to
// token-major: where the level's rows are 16-byte aligned (w_l % 4 == 0) a
// thread loads 4 consecutive tokens of one channel as a float4, lanes
// taking 8 channels x 4 quads of tokens, and lane (c, quad) writes its 4
// values in the order quad, quad + 1, ... (mod 4), so that every store of
// the warp falls in its own bank; elsewhere 4-byte loads, a warp taking 8
// consecutive tokens of 4 channels. Each thread keeps kStageBatch loads in
// flight before it stores any.
__device__ __forceinline__ void stage_level(float* slice,
                                            const float* __restrict__ vb,
                                            int n, int wl, int ch, int start) {
  constexpr int CG = kMajorChannels;
  constexpr int kStep = kMajorStagedThreads * kStageBatch;
  if (wl % 4 == 0 && reinterpret_cast<uintptr_t>(vb) % 16 == 0) {
    const int items = n / 4 * CG;  // (quad, channel)
    for (int i0 = threadIdx.x; i0 < items; i0 += kStep) {
      float4 v[kStageBatch];
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        const int i = i0 + b * kMajorStagedThreads;
        if (i < items) {
          const int tl = 4 * (i >> 3);
          const int r = tl / wl;
          v[b] = __ldg(reinterpret_cast<const float4*>(
              vb + (static_cast<size_t>(r) * ch + (i & 7)) * wl + tl -
              r * wl));
        }
      }
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        const int i = i0 + b * kMajorStagedThreads;
        if (i < items) {
          const int qd = i >> 3;
          const int c = i & 7;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = (e + qd) & 3;
            const float x = k == 0 ? v[b].x : k == 1 ? v[b].y
                            : k == 2 ? v[b].z : v[b].w;
            put_staged(slice, start + 4 * qd + k, c, x);
          }
        }
      }
    }
  } else {
    const int items = ((n + 7) & ~7) * CG;  // 8 tokens x 8 channels a block
    for (int i0 = threadIdx.x; i0 < items; i0 += kStep) {
      float v[kStageBatch];
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        const int i = i0 + b * kMajorStagedThreads;
        const int tl = (i >> 6) * 8 + (i & 7);
        if (i < items && tl < n) {
          const int r = tl / wl;
          v[b] = __ldg(vb + (static_cast<size_t>(r) * ch + ((i >> 3) & 7)) *
                                wl + tl - r * wl);
        }
      }
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        const int i = i0 + b * kMajorStagedThreads;
        const int tl = (i >> 6) * 8 + (i & 7);
        if (i < items && tl < n)
          put_staged(slice, start + tl, (i >> 3) & 7, v[b]);
      }
    }
  }
}

// one sample's coordinates and weights at the 3 levels
struct MajorPoint {
  float x[kMajorLevels];
  float y[kMajorLevels];
  float a[kMajorLevels];
};

__device__ __forceinline__ void load_major_point(
    MajorPoint& pt, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ aw, size_t gt, int s, int S) {
#pragma unroll
  for (int l = 0; l < kMajorLevels; ++l) {
    const size_t at = (gt * kMajorLevels + l) * S + s;
    pt.x[l] = __ldg(x + at);
    pt.y[l] = __ldg(y + at);
    pt.a[l] = __ldg(aw + at);
  }
}

// K5b from a slice staged in shared memory: a unit is one (slice, sample),
// slice = g * (ch / 8) + channel group, sample = t * S + s; `units` of
// them in all, this block's a contiguous range. level_start: each level's
// first token in the slice.
__global__ void __launch_bounds__(kMajorStagedThreads)
    deform_sample_major_staged_kernel(const float* __restrict__ x,
                                      const float* __restrict__ y,
                                      const float* __restrict__ aw,
                                      float* __restrict__ out, MajorLevels lv,
                                      int3 level_start, int T, int S, int ch,
                                      long long units) {
  // (tokens, 8): chunk c (4 channels) of token t at chunk c ^ ((t / 4) % 2)
  extern __shared__ __align__(16) float slice[];
  constexpr int CG = kMajorChannels;
  const int starts[kMajorLevels] = {level_start.x, level_start.y,
                                    level_start.z};
  const int groups = ch / CG;
  const long long TS = static_cast<long long>(T) * S;
  const long long begin = units * blockIdx.x / gridDim.x;
  const long long end = units * (blockIdx.x + 1) / gridDim.x;
  const float4* s4 = reinterpret_cast<const float4*>(slice);
  for (long long u = begin; u < end;) {
    const long long sl = u / TS;
    const long long seg_end = end < (sl + 1) * TS ? end : (sl + 1) * TS;
    const int g = static_cast<int>(sl / groups);
    const int cg = static_cast<int>(sl % groups);
    __syncthreads();  // every thread is done with the slice before
    stage_level(slice, lv.vm[0] + (static_cast<size_t>(g) * lv.h[0] * ch +
                                   cg * CG) * lv.w[0],
                lv.h[0] * lv.w[0], lv.w[0], ch, starts[0]);
    stage_level(slice, lv.vm[1] + (static_cast<size_t>(g) * lv.h[1] * ch +
                                   cg * CG) * lv.w[1],
                lv.h[1] * lv.w[1], lv.w[1], ch, starts[1]);
    stage_level(slice, lv.vm[2] + (static_cast<size_t>(g) * lv.h[2] * ch +
                                   cg * CG) * lv.w[2],
                lv.h[2] * lv.w[2], lv.w[2], ch, starts[2]);
    // each round's points are loaded while the round before samples
    const long long base = sl * TS;
    MajorPoint cur, next;
    {
      const long long us = u + threadIdx.x;
      if (us < seg_end) {
        const int ts = static_cast<int>(us - base);  // < T * S
        const int t = ts / S;
        load_major_point(cur, x, y, aw, static_cast<size_t>(g) * T + t,
                         ts - t * S, S);
      }
    }
    __syncthreads();
    for (long long r = u; r < seg_end; r += kMajorStagedThreads) {
      const long long us = r + threadIdx.x;
      const long long un = us + kMajorStagedThreads;
      if (un < seg_end) {
        const int ts = static_cast<int>(un - base);
        const int t = ts / S;
        load_major_point(next, x, y, aw, static_cast<size_t>(g) * T + t,
                         ts - t * S, S);
      }
      if (us < seg_end) {
        const int ts = static_cast<int>(us - base);
        const int t = ts / S;
        const int s_ = ts - t * S;
        const size_t gt = static_cast<size_t>(g) * T + t;
        float acc[CG] = {};
#pragma unroll
        for (int l = 0; l < kMajorLevels; ++l) {
          const int hl = lv.h[l];
          const int wl = lv.w[l];
          const float xs = cur.x[l] * wl - 0.5f;
          const float ys = cur.y[l] * hl - 0.5f;
          const float a = cur.a[l];
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
            const float w =
                ((q >> 1) ? wy1 : 1.f - wy1) * ((q & 1) ? wx1 : 1.f - wx1);
            const float wgt = inside ? w * a : 0.f;
            // the gather kernel reads offset 0 for a corner outside: here
            // the level's first token, with the same weight 0
            const int tok = starts[l] + (inside ? yi * wl + xi : 0);
            const int sw = (tok >> 2) & 1;
            const float4 e0 = s4[2 * tok + sw];
            const float4 e1 = s4[2 * tok + (sw ^ 1)];
            acc[0] += wgt * e0.x;
            acc[1] += wgt * e0.y;
            acc[2] += wgt * e0.z;
            acc[3] += wgt * e0.w;
            acc[4] += wgt * e1.x;
            acc[5] += wgt * e1.y;
            acc[6] += wgt * e1.z;
            acc[7] += wgt * e1.w;
          }
        }
        float* o = out + (gt * ch + cg * CG) * S + s_;
#pragma unroll
        for (int c = 0; c < CG; ++c) o[static_cast<size_t>(c) * S] = acc[c];
      }
      cur = next;
    }
    u = seg_end;
  }
}

}  // namespace

extern "C" {

// K5b. vm0 / vm1 / vm2: (G, h_l * ch, w_l); x, y, aw: (G, T, 3, S); out:
// (G, T, ch, S), all fp32 on the device. level_h / level_w: 3 host ints each.
// Launches the gather kernel on `stream` and returns cudaGetLastError().
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

// As deform_sample_major_f32, from slices of 8 channels staged in shared
// memory: ch a multiple of 8, and the 3 levels' tokens x 32 bytes within a
// block's shared memory. `device` is the current device.
int deform_sample_major_staged_f32(const float* vm0, const float* vm1,
                                   const float* vm2, const float* x,
                                   const float* y, const float* aw,
                                   float* out, const int* level_h,
                                   const int* level_w, int G, int T, int S,
                                   int ch, int device, void* stream) {
  constexpr int kMaxSmem = 232448;  // what a block may take on sm_90
  if (ch % kMajorChannels || static_cast<long long>(T) * S > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  MajorLevels lv = {{vm0, vm1, vm2}, {}, {}};
  int starts[kMajorLevels];
  int tokens = 0;
  for (int l = 0; l < kMajorLevels; ++l) {
    lv.h[l] = level_h[l];
    lv.w[l] = level_w[l];
    starts[l] = tokens;
    tokens += level_h[l] * level_w[l];
  }
  const size_t smem =
      static_cast<size_t>(tokens) * kMajorChannels * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = deform_sample_major_staged_kernel;
  // the limit raised once to the most a block may take; the blocks an SM
  // at this launch's slice size asked each time
  static KernelFacts facts;
  int sms = 0, per_sm = 0;
  cudaError_t err = facts.get(kernel, kMaxSmem, kMajorStagedThreads, device,
                              sms, per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kMajorStagedThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long units = static_cast<long long>(G) *
                          (ch / kMajorChannels) * T * S;
  const long long rounds =
      (units + kMajorStagedThreads - 1) / kMajorStagedThreads;
  const int grid = static_cast<int>(
      std::min<long long>(static_cast<long long>(sms) * per_sm, rounds));
  kernel<<<grid, kMajorStagedThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, y, aw, out, lv, make_int3(starts[0], starts[1], starts[2]), T, S,
      ch, units);
  return static_cast<int>(cudaGetLastError());
}

// value: (B, S, heads, ch); loc: (B, Lq, heads, L, P, 2); aw: (B, Lq, heads,
// L, P); out: (B, Lq, heads * ch), all fp32 on the device. level_h / level_w
// / level_start: L host ints each, L <= 4; heads * ch <= 1024. Launches the
// gather kernel on `stream` and returns cudaGetLastError().
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

// As deform_sample_f32, from slices of 8 channels staged in shared memory:
// value 16-byte aligned, ch a multiple of 8, at most 4 points a level, and
// S * 8 * 4 bytes within a block's shared memory.
int deform_sample_staged_f32(const float* value, const float* loc,
                             const float* aw, float* out, const int* level_h,
                             const int* level_w, const int* level_start, int B,
                             int S, int Lq, int heads, int ch, int L, int P,
                             void* stream) {
  if (L < 1 || L > kMaxLevels || P > kStagedPoints || ch % kStagedChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_h[l];
    lv.w[l] = level_w[l];
    lv.start[l] = level_start[l];
  }
  auto kernel = deform_sample_staged_kernel;
  const size_t smem = static_cast<size_t>(S) * kStagedChannels * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kStagedThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long units =
      static_cast<long long>(B) * heads * (ch / kStagedChannels) * Lq;
  const long long rounds = (units + kStagedThreads - 1) / kStagedThreads;
  const int grid = static_cast<int>(
      std::min<long long>(static_cast<long long>(sms) * per_sm, rounds));
  kernel<<<grid, kStagedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      value, loc, aw, out, lv, S, Lq, heads, ch, L, P, units);
  return static_cast<int>(cudaGetLastError());
}

const char* deform_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
