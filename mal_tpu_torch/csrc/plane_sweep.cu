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
// Kernel K6 is the same kernel with kOcc = true. It replaces the TPU kernel
// plane_sweep_diffs_occ_pallas (DynamicDepth's cv_set_1 volume): the
// occlusion mask occ (BF, h, w) of the lookup frame is warped with the same
// four corner weights, occ_w = ((o00 w00 + o01 w01) + o10 w10) + o11 w11,
// rounded op by op in that order as the plain version
// (plane_sweep_diffs_occ_reference) rounds it, so that the test
// occ_w > pool_th can not flip between them. Where it holds and the frame's
// apply_occ is set, the warped features are all 1.0 and the sample's value
// is mean_c |1 - cur_c|: it depends on the pixel only, so each thread sums
// its channels' share of it once, and such a sample reads no feature
// corner. The TPU kernel carries the mask as channel C+1 of its
// interpolation matmuls; here it is an input of its own.
//
// What bounds it on an H100 at the main-path shape (K1: BF=12, D=96, 48x160,
// C=64, 8.85 M samples, 6.72 M of them inside the border masks at
// chip_smoke.py's poses): the least DRAM traffic is the two feature maps
// read once (47 MB) and the volume written once (35 MB), about 25 us at
// 3.35 TB/s; the fp32 arithmetic, ~9 operations per channel for each sample
// inside the masks, is about 4 GFLOP, ~60 us on the 67 TFLOP/s non-tensor
// pipes. In practice the corners bound it: each sample inside the masks
// reads 4 corners x 256 bytes, 6.88 GB in all, which even from shared
// memory (128 bytes a clock an SM, ~30 TB/s over 132 SMs) take ~0.22 ms.
//
// Design. A tile is (frame bf, output row v, kPlanes = 8 depth planes,
// kPixels = 32 output pixels of the row). A block of 256 threads walks
// kChunks = 6 tiles of one (frame, row, segment), nearest planes first;
// each thread keeps its pixel and its projection's plane-free terms.
// 1. Projection, once per sample: thread (warp p, lane l) projects pixel
//    u0 + l at plane d0 + p with __fmul_rn / __fadd_rn / __fdiv_rn, which
//    the compiler never contracts into FMAs, in the operation order of the
//    plain version (plane_sweep_diffs_reference): both compute the same x
//    and y to the bit, so no border test and no floor() can flip between
//    them. It keeps the border decision, the corner (x0, y0) and the
//    fractions x - x0, y - y0.
// 2. The box: min and max of x0 and y0 over the tile's samples inside the
//    masks only (warp __reduce_min_sync, then shared-memory atomics), so a
//    masked sample, which may hold inf or NaN, never widens it. The box is
//    rows y0min .. y0max + 1 by columns x0min .. x0max + 1.
// 3. The route, chosen per tile on the card (the box depends on poses and
//    depth bins that live on the device; the host never looks):
//    - empty: no sample inside the masks; the tile writes zeros;
//    - staged: the box (and for K6 the box of occ) fits in kBoxBytes of
//      shared memory. Unless the box the block holds already covers it, it
//      is copied there by cp.async, kMargin = 4 columns wider on each side
//      where that fits, so that the next tiles' boxes (farther planes,
//      which move less from plane to plane) tend to fall inside it and
//      most tiles stage nothing. The layout is channel groups outermost,
//      [C/4][rows][cols] float4, each group's plane padded to a stride of 1
//      mod 8 words so that the copy's eight consecutive groups of one pixel
//      fall in distinct bank groups; 32 lanes on 32 neighbouring pixels of
//      one plane then read nearly consecutive 16-byte words of one group;
//    - direct: a box that does not fit (near planes that smear the tile
//      across the image) is read from device memory instead, with the same
//      arithmetic, but lanes on channels (step 5).
//    ops/cuda/cost_volume_kernel.py:plane_sweep_routes mirrors the choice;
//    at chip_smoke.py's poses 7.8 % (K1) and 7.5 % (K6) of the tiles with
//    a sample inside the masks take the direct route.
// 4. Each sample's corner offset (in the box, or in the frame) and its two
//    fractions go to shared memory, one float4 a sample. K6 makes its
//    occlusion decision here, from the staged (direct: the device's) occ
//    corners.
// 5. Staged: lanes on samples, warps on channels. Warp k holds channel
//    groups [k * gpw, (k + 1) * gpw) (gpw = ceil(C / 32) float4 groups; 2
//    at C=64) of its lane's pixel of cur in registers, loaded once a block,
//    and for each of the 8 planes reads the sample's state and 4 corners a
//    group, and accumulates sum |w00 a + w01 b + w10 e + w11 f - cur| in a
//    register, with no shuffle tree; the warps' partial sums meet in shared
//    memory. Direct: warp p takes plane p, C/4 lanes (a power of two, at
//    most 32) a sample, so that each corner is one contiguous read of C * 4
//    bytes, then a shuffle sum. Lanes on pixels there would read each
//    16-byte word from a cache line of its own.
// 6. Thread (p, l) adds its sample's partial sums and stores sum / C, so a
//    warp stores 32 consecutive floats of one output row.
// The channel sums round in another order than the plain version's mean:
// the tests hold them at atol 3e-5.
//
// Shared memory: kBoxBytes (40 KB) of box, 4 KB of sample state, 8 KB of
// partial sums, 48 bytes of boxes: 53.3 KB a block, four blocks (1024
// threads) an SM, at most 64 registers a thread (__launch_bounds__(256,
// 4)); ptxas spills 12 bytes of the C=64 instance (K6's: 24). Times at the
// main-path shapes (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, this
// kernel and the one it replaced in turns in one call): K1 0.4016-0.4046
// ms (was 0.8427-0.8470), K6 0.3904-0.3915 ms (was 0.9221-0.9305), against
// bounds of 0.0606 and 0.0513 ms. Variant builds that skipped one part at a time (not kept)
// put most of the time in the staged tiles' corner reads and arithmetic,
// near the shared-memory bound above, then in the projection, box
// reductions, barriers and stores, then in the direct tiles and the
// staging. Larger boxes (64-96 KB, fewer blocks an SM), 16 warps of one
// channel group, and a per-lane cache of the last corners (most samples
// inside the masks share their plane neighbour's corner) were slower:
// occupancy and registers cost more than they saved.

#include <cuda_runtime.h>

#include <climits>

#include "hopper.cuh"

namespace {

using hopper::cp_async_16;
using hopper::cp_async_4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int kPlanes = 8;                       // depth planes of a tile
constexpr int kPixels = 32;                      // output pixels of a tile
constexpr int kWarps = kPlanes;                  // one warp a plane in step 1
constexpr int kThreads = kWarps * kPixels;       // one thread a sample
constexpr int kChunks = 6;                       // tiles a block walks
constexpr int kMargin = 4;                       // extra box columns a side
constexpr int kBoxBytes = 40 * 1024;             // a block's staged box at most
constexpr int kSmemBytes = kBoxBytes + kThreads * 16 + kWarps * kThreads * 4 +
                           3 * 16;
constexpr int kMasked = -1;                      // sample offsets that are
constexpr int kOccluded = -2;                    // not a corner

// the stride between a box's channel-group planes, in float4 words, for a
// box of `pixels`: padded to 1 mod 8 (ops/cuda/cost_volume_kernel.py
// mirrors it)
__device__ __forceinline__ long long plane_stride(long long pixels) {
  return pixels + (9 - pixels % 8) % 8;
}

// sum over 4 channels of |w00 a + w01 b + w10 e + w11 f - c|, as four FMAs
// and an add a channel (the FMAs take -c, so the difference costs nothing)
__device__ __forceinline__ float l1_bilinear(float4 a, float4 b, float4 e,
                                             float4 f, float w00, float w01,
                                             float w10, float w11, float4 c) {
  return fabsf(fmaf(f.x, w11, fmaf(e.x, w10, fmaf(b.x, w01, fmaf(a.x, w00, -c.x))))) +
         fabsf(fmaf(f.y, w11, fmaf(e.y, w10, fmaf(b.y, w01, fmaf(a.y, w00, -c.y))))) +
         fabsf(fmaf(f.z, w11, fmaf(e.z, w10, fmaf(b.z, w01, fmaf(a.z, w00, -c.z))))) +
         fabsf(fmaf(f.w, w11, fmaf(e.w, w10, fmaf(b.w, w01, fmaf(a.w, w00, -c.w)))));
}

// a sample's four bilinear weights from its fractions x - x0, y - y0
__device__ __forceinline__ void bilinear_weights(float fx, float fy,
                                                 float& w00, float& w01,
                                                 float& w10, float& w11) {
  const float wx0 = 1.f - fx, wy0 = 1.f - fy;
  w00 = wx0 * wy0;
  w01 = fx * wy0;
  w10 = wx0 * fy;
  w11 = fx * fy;
}

// The staged route for one warp: acc[p] += sum over the warp's ng channel
// groups (held in c) of |bilinear(box) - cur| at its lane's pixel, for each
// of the tile's planes. box points at the warp's first group's plane; a
// sample's corner (y0, x0) of group j is box[j * stride + off], the one
// below it + cols.
template <bool kOcc, int kGroups>
__device__ __forceinline__ void staged_planes(const float4* box, int stride,
                                              int cols, int ng,
                                              const float4 (&c)[kGroups],
                                              float occ_part,
                                              const float4* info, int lane,
                                              float (&acc)[kPlanes]) {
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const float4 s = info[p * kPixels + lane];
    const int off = __float_as_int(s.z);
    if (off >= 0) {
      float w00, w01, w10, w11;
      bilinear_weights(s.x, s.y, w00, w01, w10, w11);
      const float4* q = box + off;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        if (j < ng) {
          const float4* qj = q + j * stride;
          acc[p] += l1_bilinear(qj[0], qj[1], qj[cols], qj[cols + 1], w00,
                                w01, w10, w11, c[j]);
        }
      }
    } else if (kOcc && off == kOccluded) {
      acc[p] += occ_part;
    }
  }
}

// The direct route for warp p: plane p's 32 samples from device memory,
// lanes on channels, so that a corner's channels are read as contiguous
// 16-byte words: `ls` lanes a sample (the power of two >= C / 4, at most
// 32), 32 / ls samples at a time. Each sample's sum over its channels of
// |bilinear(lookup) - cur| (K6, occluded: of |1 - cur|) goes to sums[s].
// lookup4 / cur4: the frame's first float4, at (row v, segment start) for
// cur4; a sample's offset is its corner's float4 index in the frame.
template <bool kOcc>
__device__ __forceinline__ void direct_plane(const float4* __restrict__ lookup4,
                                             const float4* __restrict__ cur4,
                                             int G, int w, int ls,
                                             const float4* info, int lane,
                                             float* sums) {
  const int sub = lane % ls;
  for (int s0 = 0; s0 < kPixels; s0 += kPixels / ls) {
    const int s = s0 + lane / ls;
    const float4 st = info[s];
    const int off = __float_as_int(st.z);
    float acc = 0.f;
    if (off >= 0) {
      float w00, w01, w10, w11;
      bilinear_weights(st.x, st.y, w00, w01, w10, w11);
      const float4* q = lookup4 + off;
      for (int g = sub; g < G; g += ls) {
        acc += l1_bilinear(__ldg(q + g), __ldg(q + G + g),
                           __ldg(q + w * G + g), __ldg(q + w * G + G + g),
                           w00, w01, w10, w11, __ldg(cur4 + s * G + g));
      }
    } else if (kOcc && off == kOccluded) {
      for (int g = sub; g < G; g += ls) {
        const float4 cg = __ldg(cur4 + s * G + g);
        acc += fabsf(1.f - cg.x) + fabsf(1.f - cg.y) + fabsf(1.f - cg.z) +
               fabsf(1.f - cg.w);
      }
    }
    for (int o = ls / 2; o > 0; o /= 2) acc += __shfl_xor_sync(~0u, acc, o);
    if (sub == 0) sums[s] = acc;
  }
}

// The part of the lookup frame a block holds in shared memory: columns
// x0 .. x0 + cols - 1 and rows y0 .. y0 + rows - 1, channel group g's plane
// at g * stride float4 words, K6's occlusion mask after the last group.
struct Box {
  int x0, y0, cols, rows, stride;
  // whether it holds the corners of the samples whose (x0, y0) span
  // [lx, hx] x [ly, hy]
  __device__ bool holds(int lx, int hx, int ly, int hy) const {
    return lx >= x0 && hx + 1 < x0 + cols && ly >= y0 && hy + 1 < y0 + rows;
  }
};

// whether a box of `pixels` fits in kBoxBytes, with K6's mask beside it
template <bool kOcc>
__device__ __forceinline__ bool fits(long long pixels, int G) {
  return plane_stride(pixels) * G * 16 + (kOcc ? pixels * 4 : 0) <= kBoxBytes;
}

// kOcc: K6, with occ (BF, h, w), apply_occ (BF,) and pool_th; K1 ignores
// them. kGroups: the float4 channel groups a warp can hold, at least
// ceil(C / 32). routes, if not null: tiles taken by each route (empty,
// staged, direct) are added there. A block walks kChunks tiles of one
// (frame, row, 32-pixel segment), nearest planes first.
template <bool kOcc, int kGroups>
__global__ void __launch_bounds__(kThreads, 4)
plane_sweep_diffs_kernel(const float* __restrict__ cur,
                         const float* __restrict__ lookup,
                         const float* __restrict__ occ,
                         const float* __restrict__ apply_occ,
                         float pool_th,
                         const float* __restrict__ M,
                         const float* __restrict__ t,
                         const float* __restrict__ bins,
                         float* __restrict__ out, int* __restrict__ routes,
                         int D, int h, int w, int C) {
  extern __shared__ __align__(16) float4 smem[];
  float4* box = smem;                                         // kBoxBytes
  float4* info = smem + kBoxBytes / 16;                       // kThreads
  float* part = reinterpret_cast<float*>(info + kThreads);    // kWarps x kThreads
  int4* red = reinterpret_cast<int4*>(part + kWarps * kThreads);  // 3 boxes

  const int tid = threadIdx.x;
  const int lane = tid % kPixels;
  const int warp = tid / kPixels;
  const int segs = (w + kPixels - 1) / kPixels;
  const int chunks = (D + kPlanes - 1) / kPlanes;
  const int runs = (chunks + kChunks - 1) / kChunks;
  int column = blockIdx.x;
  const int seg = column % segs;
  column /= segs;
  const int v = column % h;
  column /= h;
  const int run = column % runs;
  const int bf = column / runs;
  const int G = C / 4;
  const size_t frame = static_cast<size_t>(bf) * h * w;
  const bool occluding = kOcc && apply_occ[bf] > 0.f;

  // this thread's pixel u, and its projection's terms
  // (m0 * u + m1 * v) + m2, rounded op by op as the plain version does
  const int u = seg * kPixels + lane;
  const bool inner = u >= 2 && u <= w - 3 && v >= 2 && v <= h - 3;
  const float* m = M + bf * 9;
  const float* tb = t + bf * 3;
  const float uf = static_cast<float>(u);
  const float vf = static_cast<float>(v);
  const float ax = __fadd_rn(__fadd_rn(__fmul_rn(m[0], uf), __fmul_rn(m[1], vf)), m[2]);
  const float ay = __fadd_rn(__fadd_rn(__fmul_rn(m[3], uf), __fmul_rn(m[4], vf)), m[5]);
  const float az = __fadd_rn(__fadd_rn(__fmul_rn(m[6], uf), __fmul_rn(m[7], vf)), m[8]);
  const float t0 = tb[0], t1 = tb[1], t2 = tb[2];

  // this warp's channel groups of the pixel's cur, held over every plane;
  // K6: their share of an occluded sample's value, sum |1 - cur|
  const int gpw = (G + kWarps - 1) / kWarps;
  const int g0 = warp * gpw;
  const int ng = max(0, min(gpw, G - g0));
  float4 c[kGroups];
  const float4* cur4 = reinterpret_cast<const float4*>(cur) +
                       (frame + static_cast<size_t>(v) * w + min(u, w - 1)) * G + g0;
  float occ_part = 0.f;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    c[j] = j < ng ? __ldg(cur4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (kOcc && j < ng) {
      occ_part += fabsf(1.f - c[j].x) + fabsf(1.f - c[j].y) +
                  fabsf(1.f - c[j].z) + fabsf(1.f - c[j].w);
    }
  }

  // lanes a sample on the direct route: the power of two >= C / 4, <= 32
  int ls = 1;
  while (ls < G && ls < 32) ls *= 2;
  const float4* lookup4 = reinterpret_cast<const float4*>(lookup) + frame * G;
  const float4* cur_row = reinterpret_cast<const float4*>(cur) +
                          (frame + static_cast<size_t>(v) * w + seg * kPixels) * G;

  // the tiles' corner boxes, (min x0, -max x0, min y0, -max y0), reduced by
  // shared atomics in three buffers: tile k's, the one cleared for tile
  // k + 1, and tile k - 1's, which a warp may still be reading
  const int4 cleared = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  if (tid < 3) red[tid] = cleared;
  __syncthreads();

  Box held = {0, 0, 0, 0, 0};  // holds nothing yet
  const int k_end = min(chunks, (run + 1) * kChunks);
  for (int k = run * kChunks; k < k_end; ++k) {
    // 1. projection: this thread's sample is pixel u at plane d
    const int d = k * kPlanes + warp;
    bool inside = false;
    int xi = 0, yi = 0;
    float wx1 = 0.f, wy1 = 0.f;
    if (inner && d < D) {
      const float dep = bins[d];
      const float xh = __fadd_rn(__fmul_rn(dep, ax), t0);
      const float yh = __fadd_rn(__fmul_rn(dep, ay), t1);
      const float zh = __fadd_rn(__fadd_rn(__fmul_rn(dep, az), t2), 1e-7f);
      const float x = __fdiv_rn(xh, zh);
      const float y = __fdiv_rn(yh, zh);
      inside = x >= 2.f && x <= static_cast<float>(w - 2) &&
               y >= 2.f && y <= static_cast<float>(h - 2);
      if (inside) {  // the border test keeps all four corners in the image
        const float x0 = floorf(x);
        const float y0 = floorf(y);
        wx1 = __fsub_rn(x, x0);
        wy1 = __fsub_rn(y, y0);
        xi = static_cast<int>(x0);
        yi = static_cast<int>(y0);
      }
    }

    // 2. the box of the corners of the samples inside the masks
    const int k3 = k % 3;
    {
      const int lx = __reduce_min_sync(~0u, inside ? xi : INT_MAX);
      const int nhx = __reduce_min_sync(~0u, inside ? -xi : INT_MAX);
      const int ly = __reduce_min_sync(~0u, inside ? yi : INT_MAX);
      const int nhy = __reduce_min_sync(~0u, inside ? -yi : INT_MAX);
      if (lane == 0) {
        int* r = reinterpret_cast<int*>(red + k3);
        atomicMin(r + 0, lx);
        atomicMin(r + 1, nhx);
        atomicMin(r + 2, ly);
        atomicMin(r + 3, nhy);
      }
      if (tid == 0) red[(k3 + 1) % 3] = cleared;
    }
    __syncthreads();
    const int4 b = red[k3];
    const int lo_x = b.x, hi_x = -b.y, lo_y = b.z, hi_y = -b.w;
    float* dst = out + ((static_cast<size_t>(bf) * D + d) * h + v) * w + u;
    const bool stores = u < w && d < D;

    // 3. the route
    if (lo_x == INT_MAX) {  // empty: no sample inside the masks
      if (stores) *dst = 0.f;
      if (routes != nullptr && tid == 0) atomicAdd(routes + 0, 1);
      continue;
    }
    // in 64 bits: a box may span a whole large image
    const int rows = hi_y - lo_y + 2;
    const bool staged = fits<kOcc>(static_cast<long long>(rows) * (hi_x - lo_x + 2), G);
    if (routes != nullptr && tid == 0) atomicAdd(routes + (staged ? 1 : 2), 1);
    if (staged && !held.holds(lo_x, hi_x, lo_y, hi_y)) {
      // stage the box, kMargin columns wider on each side where they fit,
      // so that the next tiles' boxes (farther planes) may fall inside it
      int x0 = max(lo_x - kMargin, 0);
      int cols = min(hi_x + 1 + kMargin, w - 1) - x0 + 1;
      if (!fits<kOcc>(static_cast<long long>(rows) * cols, G)) {
        x0 = lo_x;
        cols = hi_x - lo_x + 2;
      }
      held = {x0, lo_y, cols, rows, static_cast<int>(plane_stride(rows * cols))};
      const float4* src = reinterpret_cast<const float4*>(lookup) +
                          (frame + static_cast<size_t>(lo_y) * w + x0) * G;
      const int row_words = cols * G;
      for (int y = 0; y < rows; ++y) {
        const float4* src_row = src + static_cast<size_t>(y) * w * G;
        float4* box_row = box + y * cols;
        for (int j = tid; j < row_words; j += kThreads) {
          const int col = j / G;
          cp_async_16(box_row + (j - col * G) * held.stride + col,
                      src_row + j, true);
        }
      }
      if (occluding) {
        float* obox = reinterpret_cast<float*>(box + G * held.stride);
        const float* osrc = occ + frame + static_cast<size_t>(lo_y) * w + x0;
        for (int i = tid; i < rows * cols; i += kThreads) {
          const int y = i / cols;
          cp_async_4(obox + i, osrc + static_cast<size_t>(y) * w + (i - y * cols));
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // the box has landed
    }

    // 4. each sample's corner offset and fractions; K6's occlusion decision
    int off = kMasked;
    if (inside) {
      off = staged ? (yi - held.y0) * held.cols + (xi - held.x0)
                   : (yi * w + xi) * G;
      if (occluding) {
        const float wx0 = __fsub_rn(1.f, wx1);
        const float wy0 = __fsub_rn(1.f, wy1);
        const float* o0 = staged
            ? reinterpret_cast<const float*>(box + G * held.stride) + off
            : occ + frame + yi * w + xi;
        const float* o1 = o0 + (staged ? held.cols : w);
        const float occ_w = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(o0[0], __fmul_rn(wx0, wy0)),
                                __fmul_rn(o0[1], __fmul_rn(wx1, wy0))),
                      __fmul_rn(o1[0], __fmul_rn(wx0, wy1))),
            __fmul_rn(o1[1], __fmul_rn(wx1, wy1)));
        if (occ_w > pool_th) off = kOccluded;
      }
    }
    info[tid] = make_float4(wx1, wy1, __int_as_float(off), 0.f);
    __syncthreads();  // every sample's state is written

    // 5. staged: this warp's channel groups over the tile's 8 planes, each
    // warp's partial sums in a row of part; direct: warp p's plane, whole
    // sums in part's first row
    if (staged) {
      float acc[kPlanes];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) acc[p] = 0.f;
      if (ng > 0) {
        staged_planes<kOcc, kGroups>(box + g0 * held.stride, held.stride,
                                     held.cols, ng, c, occ_part, info, lane,
                                     acc);
      }
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) part[warp * kThreads + p * kPixels + lane] = acc[p];
    } else {
      direct_plane<kOcc>(lookup4, cur_row, G, w, ls, info + warp * kPixels,
                         lane, part + warp * kPixels);
    }

    // 6. the partial sums meet
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) sum += j == 0 || staged ? part[j * kThreads + tid] : 0.f;
    if (stores) *dst = sum / static_cast<float>(C);
  }
}

template <bool kOcc, int kGroups>
int launch_groups(const float* cur, const float* lookup, const float* occ,
                  const float* apply_occ, float pool_th, const float* M,
                  const float* t, const float* bins, float* out, int* routes,
                  int BF, int D, int h, int w, int C, cudaStream_t stream) {
  auto kernel = plane_sweep_diffs_kernel<kOcc, kGroups>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (D + kPlanes - 1) / kPlanes;
  const long long blocks = static_cast<long long>(BF) * ((chunks + kChunks - 1) / kChunks) *
                           h * ((w + kPixels - 1) / kPixels);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(
      cur, lookup, occ, apply_occ, pool_th, M, t, bins, out, routes, D, h, w,
      C);
  return static_cast<int>(cudaGetLastError());
}

template <bool kOcc>
int launch(const float* cur, const float* lookup, const float* occ,
           const float* apply_occ, float pool_th, const float* M,
           const float* t, const float* bins, float* out, int* routes, int BF,
           int D, int h, int w, int C, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int gpw = (C / 4 + kWarps - 1) / kWarps;
  if (gpw <= 1)
    return launch_groups<kOcc, 1>(cur, lookup, occ, apply_occ, pool_th, M, t,
                                  bins, out, routes, BF, D, h, w, C, stream);
  if (gpw <= 2)
    return launch_groups<kOcc, 2>(cur, lookup, occ, apply_occ, pool_th, M, t,
                                  bins, out, routes, BF, D, h, w, C, stream);
  if (gpw <= 4)
    return launch_groups<kOcc, 4>(cur, lookup, occ, apply_occ, pool_th, M, t,
                                  bins, out, routes, BF, D, h, w, C, stream);
  return launch_groups<kOcc, 8>(cur, lookup, occ, apply_occ, pool_th, M, t,
                                bins, out, routes, BF, D, h, w, C, stream);
}

}  // namespace

extern "C" {

// K1. cur, lookup: (BF, h, w, C) fp32, 16-byte aligned, C % 4 == 0,
// C <= 256; M: (BF, 3, 3); t: (BF, 3); bins: (D,); out: (BF, D, h, w);
// routes: null, or 3 ints to which the tiles taken by each route (empty,
// staged, direct) are added. All on the device. Launches on `stream` and
// returns cudaGetLastError().
int plane_sweep_diffs_f32(const float* cur, const float* lookup,
                          const float* M, const float* t, const float* bins,
                          float* out, int* routes, int BF, int D, int h, int w,
                          int C, void* stream) {
  return launch<false>(cur, lookup, nullptr, nullptr, 0.f, M, t, bins, out,
                       routes, BF, D, h, w, C, stream);
}

// K6. As K1, plus occ: (BF, h, w) fp32 and apply_occ: (BF,) fp32 on the
// device, and the threshold pool_th.
int plane_sweep_diffs_occ_f32(const float* cur, const float* lookup,
                              const float* occ, const float* apply_occ,
                              float pool_th, const float* M, const float* t,
                              const float* bins, float* out, int* routes,
                              int BF, int D, int h, int w, int C,
                              void* stream) {
  return launch<true>(cur, lookup, occ, apply_occ, pool_th, M, t, bins, out,
                      routes, BF, D, h, w, C, stream);
}

const char* plane_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
