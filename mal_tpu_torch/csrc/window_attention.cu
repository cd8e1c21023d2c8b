// Swin window attention core, forward only (kernel K4).
//
// Replaces the TPU kernel mal_tpu/ops/pallas/window_attention.py:
// window_attention_fused. For every window w and head h of a Swin block:
//     out = softmax(q k^T * d^-1/2 + rpb[h] + mask[w % nm]) v,
// N = ws * ws tokens per window, head width d = 32, all in fp32 without
// tensor cores (the port's exact fp32 recipe).
//
// Inputs as the port's Swin block has them, with no transposes around the
// call: qkv (nW, N, 3C) straight from the qkv projection (q, k, v at channel
// offsets 0, C, 2C; head h at h*32 inside each), the relative-position bias
// *table* ((2ws-1)^2, heads) with the index computed here from the token
// coordinates, and the shifted-window mask (nm, N, N) as the Swin stage builds
// it. The output (nW, N, C) is the layout the output projection takes.
//
// What bounds it on an H100 at stage 0 of Swin-L at 192x640, batch 12
// (nW=672, 6 heads, N=144): about 11 GFLOP (q k^T and p v, 2 x 2 N^2 d per
// window and head), 0.17 ms on the 67 TFLOP/s fp32 pipes, against about
// 0.3 GB of traffic (qkv read once, out written once), 0.09 ms at 3.35 TB/s.
// So it is bound by operations: the design keeps the fp32 pipes fed.
//
// Three kernels, one a route, chosen by the wrapper from the window size
// (ops/cuda/window_attention.py: window_attention_route):
//
// window_attention_tiled_kernel ("tiled"), for 12x12 windows (every Swin-L
// stage). A persistent grid, one block of 12 warps per SM, walks a
// contiguous range of (window, head) pairs, ordered by mask slice (w % nm),
// then window, then head, so that a block meets one or two mask slices. Per
// pair:
// - q, k, v and the head's bias table column are staged by cp.async into one
//   of two buffers while the block computes the pair before (k and v rows
//   with their 16-byte chunks XOR-swizzled by (row / 4) % 8, so that the 16
//   keys a warp reads at once fall in distinct bank quads);
// - the shift mask is read from device memory once per mask slice that the
//   block meets, not per head or window, and kept as bits (mask != 0) with
//   its non-zero value, which lanes that find it write unordered: the value
//   added to a score is then mask[w % nm, i, j] bit for bit. A precondition
//   of this route and the w7 route, not checked here: every non-zero entry
//   of the mask holds one and the same value, as segment/swin.py:
//   shift_mask's (0 and -100 only; the port's one producer of masks) do. A
//   mask with two non-zero values gives a wrong answer, with no error;
// - each warp takes 12 queries against all 144 keys: lane (lq, lk) holds
//   queries lq + 2a (a < 6) x keys 4lk..4lk+3, 64+4lk..64+4lk+3, 128+lk, a
//   register tile of 54 scores, built as outer products 4 channels at a
//   time (6 q and 9 k float4 loads feed 216 FMAs);
// - a two-pass softmax over each query's full row, as the Pallas kernel
//   (mal_tpu/ops/pallas/window_attention.py:50-52): the max, one exp a
//   score, the sum; the row's 16 lanes reduce by shuffles. No rescaling;
// - p goes to the warp's shared memory, and p v runs register-blocked too:
//   lane (ld, lq2, ks) holds 6 queries x 8 channels over a quarter of the
//   keys (6 p and 8 v float4 loads feed 192 FMAs), and the quarters are
//   reduced by shuffles. The output is divided by the row sum at the end.
// 12 warps, not 9 of 16 queries: the 4 schedulers of an SM then take 3 warps
// each, where 9 left one scheduler with 3 and the others waiting at each
// pair's barrier.
// Shared memory: 2 x 58.3 KB of staged inputs, 81 KB of p, the mask bits:
// 203 KB, one block an SM.
//
// window_attention_w7_kernel ("w7"), for 7x7 windows (every Swin-T stage:
// MaskFormer v1). At Swin-T's shapes (batch 2 at 256x448: 320 / 80 / 24 / 8
// windows of 49 tokens, 3 / 6 / 12 / 24 heads) a launch moves 4.9-25.6 MB,
// 0.0015-0.0076 ms at 3.35 TB/s, and does 0.06-0.31 GFLOP: bound by bytes,
// and at these sizes by how long one (window, head) pair takes through a
// block (stages 1-3 have 192-480 pairs for 132 SMs). The tiled kernel's
// ideas, carried to 49-token windows:
// - a persistent grid of 4-warp blocks (4 an SM: 55.8 KB of shared memory
//   and at most 128 registers a thread), each walking a contiguous range of
//   (window, head) pairs in the tiled kernel's order (mask slice, then
//   window, then head), one pair at a time with all 4 warps;
// - q, k, v and the head's bias column staged by cp.async into one of two
//   buffers while the block computes the pair before, 49 rows each; q and
//   k rows padded to 36 floats, so that the 8 rows a quarter-warp reads at
//   once start in distinct bank quads and every load of the products is a
//   constant offset from a pointer set up once;
// - the mask as bits plus its one non-zero value, built once per mask
//   slice that the block meets, its loads overlapping the copies in flight
//   (the tiled kernel's precondition, below);
// - warp w takes queries w, w + 4, ... (16 slots, 12 or 13 of them real)
//   against 56 keys (49, and 7 whose scores are set to -inf): lane (lq, lk)
//   holds slots lq + 4a x keys lk + 8c (a < 4, c < 7), a register tile of 28
//   scores built as outer products 4 channels at a time (4 q and 7 k float4
//   loads feed 112 FMAs). Padding slots and keys read real rows (a query
//   the warp owns, key 48) and are never stored, so nothing is zero-filled;
// - the Pallas kernel's two-pass softmax over each query's full row (max,
//   exp, sum over the row's 8 lanes by shuffles), no rescaling;
// - p through the warp's own slots in shared memory, then p v with lane
//   (lq, lc) holding slots lq + 4a x channels 4lc..4lc+3 over keys in fours
//   (4 p and 4 v float4 loads feed 64 FMAs), divided by the row sum at the
//   end.
// What holds it (tools/ablate_w7.py times it with parts taken out): the two
// products, whose float4 shared-memory reads outnumber what their FMAs
// need, and one pair's latency through its block; not the bytes.
//
// window_attention_kernel ("loop"), for the other window sizes (any ws <=
// 16; no model in the repo runs one): one block per (window, head), one
// thread per query, k and v in shared memory, an online softmax over the
// keys in registers. It reads the symmetric mask by columns (mask[m][j][i]
// for query i and key j), so that lanes of consecutive queries read
// consecutive addresses. It takes 7x7 and 12x12 windows too when asked
// (route "loop"), to time the other routes against it.
//
// Every entry reads its launch facts (the SM count, the shared memory
// limit, blocks an SM) once per device and process (hopper.cuh:
// KernelFacts), not on every launch.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 32;  // head width

// ----------------------------------------------------------- any window

__global__ void window_attention_kernel(const float* __restrict__ qkv,
                                        const float* __restrict__ table,
                                        const float* __restrict__ mask,
                                        float* __restrict__ out,
                                        int heads, int ws, int nm,
                                        float scale) {
  extern __shared__ float4 smem4[];
  const int N = ws * ws;
  const int C = heads * kD;
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int span = 2 * ws - 1;

  float4* ks = smem4;                 // (N, 8) float4
  float4* vs = ks + N * (kD / 4);     // (N, 8) float4
  float* tab = reinterpret_cast<float*>(vs + N * (kD / 4));  // span^2

  const float* base = qkv + static_cast<size_t>(w) * N * 3 * C + h * kD;
  for (int idx = threadIdx.x; idx < N * (kD / 4); idx += blockDim.x) {
    const int n = idx / (kD / 4);
    const int g = idx % (kD / 4);
    const float4* row = reinterpret_cast<const float4*>(
        base + static_cast<size_t>(n) * 3 * C);
    ks[idx] = row[C / 4 + g];
    vs[idx] = row[2 * C / 4 + g];
  }
  for (int idx = threadIdx.x; idx < span * span; idx += blockDim.x)
    tab[idx] = table[idx * heads + h];
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= N) return;

  float q[kD];
  const float4* qrow = reinterpret_cast<const float4*>(
      base + static_cast<size_t>(i) * 3 * C);
#pragma unroll
  for (int g = 0; g < kD / 4; ++g) {
    const float4 a = qrow[g];
    q[4 * g] = a.x * scale;
    q[4 * g + 1] = a.y * scale;
    q[4 * g + 2] = a.z * scale;
    q[4 * g + 3] = a.w * scale;
  }
  const int yi = i / ws;
  const int xi = i - yi * ws;
  // table row of (query i, key j): (yi - yj + ws - 1) * span + xi - xj + ws - 1
  const float* trow = tab + (yi + ws - 1) * span + xi + ws - 1;
  // column i of the symmetric mask = row i
  const float* mcol = mask ? mask + static_cast<size_t>(w % nm) * N * N + i
                           : nullptr;

  float m = -INFINITY;
  float l = 0.f;
  float acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] = 0.f;

  int yj = 0, xj = 0;
  for (int j = 0; j < N; ++j) {
    const float4* kr = ks + j * (kD / 4);
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kD / 4; ++g) {
      const float4 k = kr[g];
      s += q[4 * g] * k.x + q[4 * g + 1] * k.y + q[4 * g + 2] * k.z +
           q[4 * g + 3] * k.w;
    }
    s += trow[-(yj * span + xj)];
    if (mcol) s += mcol[static_cast<size_t>(j) * N];
    if (s > m) {
      const float corr = expf(m - s);  // 0 on the first key
      l *= corr;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[c] *= corr;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
    const float4* vr = vs + j * (kD / 4);
#pragma unroll
    for (int g = 0; g < kD / 4; ++g) {
      const float4 v = vr[g];
      acc[4 * g] += p * v.x;
      acc[4 * g + 1] += p * v.y;
      acc[4 * g + 2] += p * v.z;
      acc[4 * g + 3] += p * v.w;
    }
    if (++xj == ws) {
      xj = 0;
      ++yj;
    }
  }

  const float inv = 1.f / l;
  float4* orow = reinterpret_cast<float4*>(
      out + (static_cast<size_t>(w) * N + i) * C + h * kD);
#pragma unroll
  for (int g = 0; g < kD / 4; ++g)
    orow[g] = make_float4(acc[4 * g] * inv, acc[4 * g + 1] * inv,
                          acc[4 * g + 2] * inv, acc[4 * g + 3] * inv);
}

// ----------------------------------------------------- 12x12 windows, tiled

constexpr int kWs = 12;
constexpr int kN = kWs * kWs;        // 144 tokens
constexpr int kSpan = 2 * kWs - 1;   // 23
constexpr int kTab = kSpan * kSpan;  // 529 rows of the bias table
constexpr int kQw = 12;              // queries a warp
constexpr int kQa = kQw / 2;         // queries a lane (two lanes share a key)
constexpr int kWarps = kN / kQw;     // 12 warps, 3 on each scheduler
constexpr int kThreads = 32 * kWarps;
constexpr int kQld = kD + 4;         // q row stride: rows one bank quad apart
constexpr int kBitWords = 8;         // mask words a query row, 5 used

// One (window, head) pair's inputs. Chunk g (4 floats) of k or v row j sits
// at chunk g ^ swz(j).
struct Stage {
  float q[kN * kQld];
  float k[kN * kD];
  float v[kN * kD];
  float tab[kTab + 3];
};

struct TiledSmem {
  Stage stage[2];
  float p[kWarps][kQw * kN];       // each warp's probabilities, row-major
  float inv_l[kN];                 // 1 / row sum, by query
  // bit L of word c of query i's row: mask[i][4L + c] != 0 (keys 0-127),
  // bit L of word 4: mask[i][128 + L]
  uint32_t bits[kN * kBitWords];
  float mask_value;                // the mask's non-zero value
};

__device__ __forceinline__ int swz(int row) { return (row >> 2) & 7; }

// Pair p's window and head. Pairs run mask slice by mask slice (windows m,
// m + nm, m + 2 nm, ...), each window's heads in turn, so that a block's
// range of pairs holds few mask slices.
__device__ __forceinline__ void pair_of(int p, int heads, int nm, int images,
                                        int& w, int& h) {
  const int per_slice = images * heads;
  const int m = p / per_slice;
  const int r = p - m * per_slice;
  w = r / heads * nm + m;
  h = r % heads;
}

// cp.async the inputs of window w, head h into `st`
__device__ __forceinline__ void stage_pair(Stage& st,
                                           const float* __restrict__ qkv,
                                           const float* __restrict__ table,
                                           int w, int h, int heads) {
  const int C = heads * kD;
  const float* base = qkv + static_cast<size_t>(w) * kN * 3 * C + h * kD;
  for (int idx = threadIdx.x; idx < kN * (kD / 4); idx += kThreads) {
    const int n = idx >> 3;
    const int g = idx & 7;
    const float* row = base + static_cast<size_t>(n) * 3 * C + 4 * g;
    const int sg = 4 * (g ^ swz(n));
    cp_async_16(st.q + n * kQld + 4 * g, row, true);
    cp_async_16(st.k + n * kD + sg, row + C, true);
    cp_async_16(st.v + n * kD + sg, row + 2 * C, true);
  }
  for (int idx = threadIdx.x; idx < kTab; idx += kThreads)
    cp_async_4(st.tab + idx, table + idx * heads + h);
}

// the bits and the non-zero value of one window's (N, N) mask; each warp
// loads all of its rows before it waits on any
__device__ __forceinline__ void compact_mask(TiledSmem& sm,
                                             const float* __restrict__ mw,
                                             int warp, int lane) {
  constexpr int kRows = kN / kWarps;
  float4 rows[kRows];
  float tails[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* row = mw + (warp + r * kWarps) * kN;
    rows[r] = reinterpret_cast<const float4*>(row)[lane];
    tails[r] = lane < kN - 128 ? row[128 + lane] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + r * kWarps;
    const float4 a = rows[r];
    const float t = tails[r];
    const uint32_t b0 = __ballot_sync(~0u, a.x != 0.f);
    const uint32_t b1 = __ballot_sync(~0u, a.y != 0.f);
    const uint32_t b2 = __ballot_sync(~0u, a.z != 0.f);
    const uint32_t b3 = __ballot_sync(~0u, a.w != 0.f);
    const uint32_t b4 = __ballot_sync(~0u, t != 0.f);
    if (lane == 0) {
      *reinterpret_cast<uint4*>(sm.bits + i * kBitWords) =
          make_uint4(b0, b1, b2, b3);
      sm.bits[i * kBitWords + 4] = b4;
    }
    const float nz = a.x != 0.f   ? a.x
                     : a.y != 0.f ? a.y
                     : a.z != 0.f ? a.z
                     : a.w != 0.f ? a.w
                                  : t;
    if (nz != 0.f) sm.mask_value = nz;
  }
}

// one warp's 12 queries of one staged pair; out points at the pair's
// (window, head) corner of the output
__device__ __forceinline__ void attend(TiledSmem& sm, Stage& st, bool masked,
                                       float* __restrict__ out, int C,
                                       float scale, int warp, int lane) {
  const int q0 = kQw * warp;
  float* qs = st.q + q0 * kQld;
  // scale the warp's own q rows in place, as the plain version does
#pragma unroll
  for (int c = lane; c < kQw * (kD / 4); c += 32) {
    float4* x = reinterpret_cast<float4*>(qs + (c >> 3) * kQld) + (c & 7);
    *x = make_float4(x->x * scale, x->y * scale, x->z * scale, x->w * scale);
  }
  __syncwarp();

  // scores: lane (lq, lk) holds queries lq + 2a x keys 4lk + c (kk = c),
  // 64 + 4lk + c (kk = 4 + c) and 128 + lk (kk = 8)
  const int lq = lane >> 4;
  const int lk = lane & 15;
  float s[kQa][9];
#pragma unroll
  for (int a = 0; a < kQa; ++a)
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) s[a][kk] = 0.f;
  const float* kA = st.k + 4 * lk * kD;          // keys 4lk.. (+64 rows: B)
  const float* kT = st.k + (128 + lk) * kD;
  const int swA = lk & 7;                        // swz of keys A and B
  const int swT = lk >> 2;                       // swz of key 128 + lk
#pragma unroll
  for (int g = 0; g < kD / 4; ++g) {
    float4 qv[kQa];
#pragma unroll
    for (int a = 0; a < kQa; ++a)
      qv[a] = *reinterpret_cast<const float4*>(qs + (lq + 2 * a) * kQld +
                                               4 * g);
    const float* ka = kA + 4 * (g ^ swA);
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) {
      const float* kr = kk < 4   ? ka + kk * kD
                        : kk < 8 ? ka + (60 + kk) * kD
                                 : kT + 4 * (g ^ swT);
      const float4 kv = *reinterpret_cast<const float4*>(kr);
#pragma unroll
      for (int a = 0; a < kQa; ++a) {
        s[a][kk] = fmaf(qv[a].x, kv.x, s[a][kk]);
        s[a][kk] = fmaf(qv[a].y, kv.y, s[a][kk]);
        s[a][kk] = fmaf(qv[a].z, kv.z, s[a][kk]);
        s[a][kk] = fmaf(qv[a].w, kv.w, s[a][kk]);
      }
    }
  }

  // + bias, + mask. Keys 4lk..4lk+3 (and 64 + the same) lie in one row of
  // the window (12 is a multiple of 4), so their table rows are consecutive.
  const int jB = 64 + 4 * lk;
  const int jT = 128 + lk;
  const int offA = (4 * lk / kWs) * kSpan + 4 * lk % kWs;
  const int offB = (jB / kWs) * kSpan + jB % kWs;
  const int offT = (jT / kWs) * kSpan + jT % kWs;
  const float mv = sm.mask_value;
#pragma unroll
  for (int a = 0; a < kQa; ++a) {
    const int i = q0 + lq + 2 * a;
    const float* trow = st.tab + (i / kWs + kWs - 1) * kSpan + i % kWs +
                        kWs - 1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[a][c] += trow[-offA - c];
      s[a][4 + c] += trow[-offB - c];
    }
    s[a][8] += trow[-offT];
    if (masked) {
      const uint4 wq = *reinterpret_cast<const uint4*>(sm.bits +
                                                       i * kBitWords);
      const uint32_t wc[4] = {wq.x >> lk, wq.y >> lk, wq.z >> lk,
                              wq.w >> lk};
      const uint32_t w4 = sm.bits[i * kBitWords + 4] >> lk;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (wc[c] & 1u) s[a][c] += mv;
        if (wc[c] & 0x10000u) s[a][4 + c] += mv;
      }
      if (w4 & 1u) s[a][8] += mv;
    }
  }

  // two-pass softmax over each row of 144, held by the 16 lanes of one lq
  float* pw = sm.p[warp];
#pragma unroll
  for (int a = 0; a < kQa; ++a) {
    float mx = s[a][0];
#pragma unroll
    for (int kk = 1; kk < 9; ++kk) mx = fmaxf(mx, s[a][kk]);
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    float l = 0.f;
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) {
      s[a][kk] = expf(s[a][kk] - mx);
      l += s[a][kk];
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) l += __shfl_xor_sync(~0u, l, o);
    if (lk == 0) sm.inv_l[q0 + lq + 2 * a] = 1.f / l;
    float* prow = pw + (lq + 2 * a) * kN;
    *reinterpret_cast<float4*>(prow + 4 * lk) =
        make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    *reinterpret_cast<float4*>(prow + 64 + 4 * lk) =
        make_float4(s[a][4], s[a][5], s[a][6], s[a][7]);
    prow[128 + lk] = s[a][8];
  }
  __syncwarp();

  // p v: lane (ld, lq2, ks) sums queries lq2 + 2a (a < 6) x channels
  // 8ld..8ld+7 over the keys 4c..4c+3 of the chunks c = 4t + ks
  const int ks = lane & 3;
  const int lq2 = (lane >> 2) & 1;
  const int ld = lane >> 3;
  float acc[kQa][8];
#pragma unroll
  for (int a = 0; a < kQa; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  const float* pq = pw + lq2 * kN;
#pragma unroll 3
  for (int t = 0; t < kN / 16; ++t) {
    const int c = 4 * t + ks;
    float4 pv[kQa];
#pragma unroll
    for (int a = 0; a < kQa; ++a)
      pv[a] = *reinterpret_cast<const float4*>(pq + 2 * a * kN + 4 * c);
    const int sw = c & 7;  // swz of rows 4c..4c+3
    const float4* v0 = reinterpret_cast<const float4*>(st.v + 4 * c * kD) +
                       ((2 * ld) ^ sw);
    const float4* v1 = reinterpret_cast<const float4*>(st.v + 4 * c * kD) +
                       ((2 * ld + 1) ^ sw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 x = v0[e * (kD / 4)];
      const float4 y = v1[e * (kD / 4)];
#pragma unroll
      for (int a = 0; a < kQa; ++a) {
        const float p = e == 0 ? pv[a].x : e == 1 ? pv[a].y
                                 : e == 2 ? pv[a].z : pv[a].w;
        acc[a][0] = fmaf(p, x.x, acc[a][0]);
        acc[a][1] = fmaf(p, x.y, acc[a][1]);
        acc[a][2] = fmaf(p, x.z, acc[a][2]);
        acc[a][3] = fmaf(p, x.w, acc[a][3]);
        acc[a][4] = fmaf(p, y.x, acc[a][4]);
        acc[a][5] = fmaf(p, y.y, acc[a][5]);
        acc[a][6] = fmaf(p, y.z, acc[a][6]);
        acc[a][7] = fmaf(p, y.w, acc[a][7]);
      }
    }
  }

  // sum the four key quarters: lane ks keeps queries a in 3 hb.. and
  // channels 4 lb.. of its 6 x 8 tile
  constexpr int kHalf = kQa / 2;
  const bool hb = ks & 2;
  const bool lb = ks & 1;
  float r[kHalf][8];
#pragma unroll
  for (int a = 0; a < kHalf; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float send = hb ? acc[a][b] : acc[kHalf + a][b];
      const float keep = hb ? acc[kHalf + a][b] : acc[a][b];
      r[a][b] = keep + __shfl_xor_sync(~0u, send, 2);
    }
#pragma unroll
  for (int a = 0; a < kHalf; ++a) {
    float o[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float send = lb ? r[a][b] : r[a][4 + b];
      const float keep = lb ? r[a][4 + b] : r[a][b];
      o[b] = keep + __shfl_xor_sync(~0u, send, 1);
    }
    const int i = q0 + lq2 + 2 * (kHalf * hb + a);
    const float il = sm.inv_l[i];
    *reinterpret_cast<float4*>(out + static_cast<size_t>(i) * C + 8 * ld +
                               4 * lb) =
        make_float4(o[0] * il, o[1] * il, o[2] * il, o[3] * il);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    window_attention_tiled_kernel(const float* __restrict__ qkv,
                                  const float* __restrict__ table,
                                  const float* __restrict__ mask,
                                  float* __restrict__ out, int pairs,
                                  int heads, int nm, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TiledSmem& sm = *reinterpret_cast<TiledSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = heads * kD;
  // a contiguous range of (window, head) pairs, heads of one window in turn
  const int begin = static_cast<int>(static_cast<long long>(pairs) *
                                     blockIdx.x / gridDim.x);
  const int end = static_cast<int>(static_cast<long long>(pairs) *
                                   (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;

  const int images = pairs / (heads * nm);
  int w, h;
  pair_of(begin, heads, nm, images, w, h);
  stage_pair(sm.stage[0], qkv, table, w, h, heads);
  cp_async_commit();
  int held = -1;  // the mask slice held as bits
  for (int p = begin; p < end; ++p) {
    const int slot = (p - begin) & 1;
    // the other buffer was last read before the barrier that ended the
    // previous pair
    if (p + 1 < end) {
      int wn, hn;
      pair_of(p + 1, heads, nm, images, wn, hn);
      stage_pair(sm.stage[slot ^ 1], qkv, table, wn, hn, heads);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this pair's copies have landed
    __syncthreads();
    pair_of(p, heads, nm, images, w, h);
    if (mask != nullptr && w % nm != held) {
      held = w % nm;
      compact_mask(sm, mask + static_cast<size_t>(held) * kN * kN, warp, lane);
      __syncthreads();
    }
    attend(sm, sm.stage[slot], mask != nullptr,
           out + static_cast<size_t>(w) * kN * C + h * kD, C, scale, warp,
           lane);
    __syncthreads();
  }
}

// ------------------------------------------------------- 7x7 windows, w7

constexpr int kWs7 = 7;
constexpr int kN7 = kWs7 * kWs7;        // 49 tokens
constexpr int kSpan7 = 2 * kWs7 - 1;    // 13
constexpr int kTab7 = kSpan7 * kSpan7;  // 169 rows of the bias table
constexpr int kW7Warps = 4;
constexpr int kW7Threads = 32 * kW7Warps;
constexpr int kSlots7 = 16;             // query slots a warp, 4 a lane
constexpr int kKeys7 = 56;              // keys a row of scores: 7 a lane
constexpr int kPld7 = kKeys7;           // p row stride: 4 rows fall 8 banks
                                        // apart, float4 rows 2 quads apart
constexpr int kPv7 = 52;                // keys p v reads, in fours
constexpr int kLd7 = kD + 4;            // q and k row stride: 9 bank quads

// One (window, head) pair's inputs, 49 rows each. q and k rows are padded
// to 36 floats, so that 8 consecutive rows start in 8 distinct bank quads
// and every load of the products takes a constant offset from a pointer
// set up once (no swizzle arithmetic); query i sits at row q_row7(i), so
// that a warp's queries are consecutive rows. v rows are read whole, 8
// lanes a row, and keep 32 floats.
struct Stage7 {
  float q[kN7 * kLd7];
  float k[kN7 * kLd7];
  float v[kN7 * kD];
  float tab[kTab7 + 3];
};

struct W7Smem {
  Stage7 stage[2];
  float p[kW7Warps][kSlots7 * kPld7];  // each warp's probabilities by slot
  float inv_l[kW7Warps][kSlots7];      // 1 / row sum, by slot
  // bit j of word 0 of query i's row: mask[i][j] != 0 (keys 0-31); word 1:
  // keys 32-48
  uint32_t bits[2 * kN7 + 2];
  float mask_value;                    // the mask's non-zero value
};

// query i = w + 4m (warp w's slot m) at row 12w + m, query 48 at row 48
__device__ __forceinline__ int q_row7(int i) {
  return i < 48 ? (i & 3) * 12 + (i >> 2) : 48;
}

// cp.async the inputs of window w, head h into `st`
__device__ __forceinline__ void stage_pair7(Stage7& st,
                                            const float* __restrict__ qkv,
                                            const float* __restrict__ table,
                                            int w, int h, int heads) {
  const int C = heads * kD;
  const float* base = qkv + static_cast<size_t>(w) * kN7 * 3 * C + h * kD;
  for (int idx = threadIdx.x; idx < kN7 * (kD / 4); idx += kW7Threads) {
    const int n = idx >> 3;
    const int g = idx & 7;
    const float* row = base + static_cast<size_t>(n) * 3 * C + 4 * g;
    cp_async_16(st.q + q_row7(n) * kLd7 + 4 * g, row, true);
    cp_async_16(st.k + n * kLd7 + 4 * g, row + C, true);
    cp_async_16(st.v + n * kD + 4 * g, row + 2 * C, true);
  }
  for (int idx = threadIdx.x; idx < kTab7; idx += kW7Threads)
    cp_async_4(st.tab + idx, table + idx * heads + h);
}

// the bits and the non-zero value of one window's (49, 49) mask: warp w
// takes rows w, w + 4, ..., loading all of them before it waits on any
__device__ __forceinline__ void compact_mask7(W7Smem& sm,
                                              const float* __restrict__ mw,
                                              int warp, int lane) {
  constexpr int kRows = (kN7 + kW7Warps - 1) / kW7Warps;  // 13
  float lo[kRows], hi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + r * kW7Warps;
    const float* row = mw + i * kN7;
    lo[r] = i < kN7 ? row[lane] : 0.f;
    hi[r] = i < kN7 && lane < kN7 - 32 ? row[32 + lane] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + r * kW7Warps;
    const uint32_t b0 = __ballot_sync(~0u, lo[r] != 0.f);
    const uint32_t b1 = __ballot_sync(~0u, hi[r] != 0.f);
    if (i < kN7) {
      if (lane == 0) {
        sm.bits[2 * i] = b0;
        sm.bits[2 * i + 1] = b1;
      }
      const float nz = lo[r] != 0.f ? lo[r] : hi[r];
      if (nz != 0.f) sm.mask_value = nz;
    }
  }
}

// bias-table offset of token j inside its window: yj * 13 + xj
__device__ __forceinline__ int tab_off7(int j) {
  return j / kWs7 * kSpan7 + j % kWs7;
}

// One warp's query slots of one staged pair: slot m (0..15) of warp w is
// query i = w + 4m, valid below 49. A padding slot computes the query of
// slot m - 4 (one of the warp's own rows) and is never stored; a padding
// key (49..55) reads key 48 and its score is set to -inf. out points at
// the pair's (window, head) corner of the output.
__device__ __forceinline__ void attend7(W7Smem& sm, Stage7& st, bool masked,
                                        float* __restrict__ out, int C,
                                        float scale, int warp, int lane) {
  // scale the warp's own q rows in place (12, and query 48 for warp 0), as
  // the plain version does
  const int own = warp == 0 ? 13 : 12;
  for (int c = lane; c < own * (kD / 4); c += 32) {
    const int row = (c >> 3) < 12 ? 12 * warp + (c >> 3) : 48;
    float4* x = reinterpret_cast<float4*>(st.q + row * kLd7) + (c & 7);
    *x = make_float4(x->x * scale, x->y * scale, x->z * scale, x->w * scale);
  }
  __syncwarp();

  // scores: lane (lq, lk) holds slots lq + 4a x keys lk + 8c
  const int lk = lane & 7;
  const int lq = lane >> 3;
  int qi[4];  // the query row each slot computes
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = warp + kW7Warps * (lq + 4 * a);
    qi[a] = i < kN7 ? i : i - 4 * kW7Warps;
  }
  int kj[7];  // the key row each score reads
#pragma unroll
  for (int c = 0; c < 7; ++c) kj[c] = min(lk + 8 * c, kN7 - 1);
  const float4* qr[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    qr[a] = reinterpret_cast<const float4*>(st.q + q_row7(qi[a]) * kLd7);
  const float4* kr[7];
#pragma unroll
  for (int c = 0; c < 7; ++c)
    kr[c] = reinterpret_cast<const float4*>(st.k + kj[c] * kLd7);
  float s[4][7];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 7; ++c) s[a][c] = 0.f;
#pragma unroll
  for (int g = 0; g < kD / 4; ++g) {
    float4 qv[4], kv[7];
#pragma unroll
    for (int a = 0; a < 4; ++a) qv[a] = qr[a][g];
#pragma unroll
    for (int c = 0; c < 7; ++c) kv[c] = kr[c][g];
    // each channel's 28 products in turn: consecutive FMAs are independent
#pragma unroll
    for (int c = 0; c < 7; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) s[a][c] = fmaf(qv[a].x, kv[c].x, s[a][c]);
#pragma unroll
    for (int c = 0; c < 7; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) s[a][c] = fmaf(qv[a].y, kv[c].y, s[a][c]);
#pragma unroll
    for (int c = 0; c < 7; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) s[a][c] = fmaf(qv[a].z, kv[c].z, s[a][c]);
#pragma unroll
    for (int c = 0; c < 7; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) s[a][c] = fmaf(qv[a].w, kv[c].w, s[a][c]);
  }

  // + bias, + mask; the padding keys (c = 6, lk > 0) to -inf
  int off[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) off[c] = tab_off7(kj[c]);
  const float mv = sm.mask_value;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* trow =
        st.tab + tab_off7(qi[a]) + (kWs7 - 1) * kSpan7 + kWs7 - 1;
#pragma unroll
    for (int c = 0; c < 7; ++c) s[a][c] += trow[-off[c]];
    if (masked) {
      const uint32_t b0 = sm.bits[2 * qi[a]] >> lk;      // keys lk + 8c, c < 4
      const uint32_t b1 = sm.bits[2 * qi[a] + 1] >> lk;  // c >= 4
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (b0 & (1u << (8 * c))) s[a][c] += mv;
#pragma unroll
      for (int c = 4; c < 7; ++c)
        if (b1 & (1u << (8 * (c - 4)))) s[a][c] += mv;
    }
    if (lk > 0) s[a][6] = -INFINITY;
  }

  // two-pass softmax over each row of 56, held by the 8 lanes of one lq
  float* pw = sm.p[warp];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float mx = s[a][0];
#pragma unroll
    for (int c = 1; c < 7; ++c) mx = fmaxf(mx, s[a][c]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      s[a][c] = expf(s[a][c] - mx);
      l += s[a][c];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) l += __shfl_xor_sync(~0u, l, o);
    const int m = lq + 4 * a;
    if (lk == 0) sm.inv_l[warp][m] = 1.f / l;
#pragma unroll
    for (int c = 0; c < 7; ++c) pw[m * kPld7 + lk + 8 * c] = s[a][c];
  }
  __syncwarp();

  // p v: lane (lq, lc) sums slots lq + 4a x channels 4lc..4lc+3 over keys
  // 4t..4t+3 (keys 49..51: p = 0 on key 48's values)
  const int lc = lane & 7;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll
  for (int t = 0; t < kPv7 / 4; ++t) {
    float4 pv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      pv[a] = *reinterpret_cast<const float4*>(pw + (lq + 4 * a) * kPld7 +
                                               4 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = min(4 * t + e, kN7 - 1);
      const float4 x = *reinterpret_cast<const float4*>(st.v + j * kD +
                                                        4 * lc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pe = e == 0 ? pv[a].x : e == 1 ? pv[a].y
                         : e == 2 ? pv[a].z : pv[a].w;
        acc[a][0] = fmaf(pe, x.x, acc[a][0]);
        acc[a][1] = fmaf(pe, x.y, acc[a][1]);
        acc[a][2] = fmaf(pe, x.z, acc[a][2]);
        acc[a][3] = fmaf(pe, x.w, acc[a][3]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = lq + 4 * a;
    const int i = warp + kW7Warps * m;
    if (i < kN7) {
      const float il = sm.inv_l[warp][m];
      *reinterpret_cast<float4*>(out + static_cast<size_t>(i) * C + 4 * lc) =
          make_float4(acc[a][0] * il, acc[a][1] * il, acc[a][2] * il,
                      acc[a][3] * il);
    }
  }
}

__global__ void __launch_bounds__(kW7Threads, 4)
    window_attention_w7_kernel(const float* __restrict__ qkv,
                               const float* __restrict__ table,
                               const float* __restrict__ mask,
                               float* __restrict__ out, int pairs, int heads,
                               int nm, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W7Smem& sm = *reinterpret_cast<W7Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = heads * kD;
  const int begin = static_cast<int>(static_cast<long long>(pairs) *
                                     blockIdx.x / gridDim.x);
  const int end = static_cast<int>(static_cast<long long>(pairs) *
                                   (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;

  const int images = pairs / (heads * nm);
  int w, h;
  pair_of(begin, heads, nm, images, w, h);
  stage_pair7(sm.stage[0], qkv, table, w, h, heads);
  cp_async_commit();
  int held = -1;  // the mask slice held as bits
  for (int p = begin; p < end; ++p) {
    const int slot = (p - begin) & 1;
    // the other buffer, and the bits, were last read before the barrier
    // that ended the previous pair
    if (p + 1 < end) {
      int wn, hn;
      pair_of(p + 1, heads, nm, images, wn, hn);
      stage_pair7(sm.stage[slot ^ 1], qkv, table, wn, hn, heads);
    }
    cp_async_commit();
    pair_of(p, heads, nm, images, w, h);
    // the mask's loads overlap the copies in flight
    if (mask != nullptr && w % nm != held) {
      held = w % nm;
      compact_mask7(sm, mask + static_cast<size_t>(held) * kN7 * kN7, warp,
                    lane);
    }
    cp_async_wait<1>();  // this pair's copies have landed
    __syncthreads();
    attend7(sm, sm.stage[slot], mask != nullptr,
            out + static_cast<size_t>(w) * kN7 * C + h * kD, C, scale, warp,
            lane);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// qkv: (nW, N, 3 * heads * 32) fp32, 16-byte aligned; table: ((2ws-1)^2,
// heads); mask: (nm, N, N) symmetric shift mask, or null; out: (nW, N,
// heads * 32). ws <= 16. All on `device`, the current device. Launches the
// loop kernel on `stream` and returns cudaGetLastError().
int window_attention_f32(const float* qkv, const float* table,
                         const float* mask, float* out, int nW, int heads,
                         int ws, int nm, int device, void* stream) {
  constexpr int kMaxWs = 16;
  if (ws < 1 || ws > kMaxWs) return static_cast<int>(cudaErrorInvalidValue);
  // the limit is raised once, to what the largest window takes
  static KernelFacts facts;
  const int max_smem = (2 * kMaxWs * kMaxWs * kD +
                        (2 * kMaxWs - 1) * (2 * kMaxWs - 1)) * sizeof(float);
  int sms = 0, per_sm = 0;
  const cudaError_t err = facts.get(window_attention_kernel, max_smem,
                                    kMaxWs * kMaxWs, device, sms, per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int N = ws * ws;
  const int span = 2 * ws - 1;
  const size_t smem = 2 * static_cast<size_t>(N) * kD * sizeof(float) +
                      static_cast<size_t>(span) * span * sizeof(float);
  const dim3 grid(nW, heads);
  const dim3 block((N + 31) / 32 * 32);
  window_attention_kernel<<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      qkv, table, mask, out, heads, ws, nm,
      static_cast<float>(1.0 / sqrt(static_cast<double>(kD))));
  return static_cast<int>(cudaGetLastError());
}

// As window_attention_f32, for ws = 12 only: launches the tiled kernel. The
// mask (if any) is 16-byte aligned and, a precondition this does not check,
// holds 0 and one non-zero value only, as shift_mask's do.
int window_attention_tiled_f32(const float* qkv, const float* table,
                               const float* mask, float* out, int nW,
                               int heads, int ws, int nm, int device,
                               void* stream) {
  if (ws != kWs) return static_cast<int>(cudaErrorInvalidValue);
  static KernelFacts facts;
  const int smem = static_cast<int>(sizeof(TiledSmem));
  int sms = 0, per_sm = 0;
  const cudaError_t err = facts.get(window_attention_tiled_kernel, smem,
                                    kThreads, device, sms, per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = nW * heads;
  window_attention_tiled_kernel<<<std::min(pairs, sms), kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      qkv, table, mask, out, pairs, heads, nm,
      static_cast<float>(1.0 / sqrt(static_cast<double>(kD))));
  return static_cast<int>(cudaGetLastError());
}

// As window_attention_tiled_f32, for ws = 7 only: launches the w7 kernel,
// as many blocks as fit on the card at once, or one a pair where there are
// fewer pairs. The same precondition on the mask.
int window_attention_w7_f32(const float* qkv, const float* table,
                            const float* mask, float* out, int nW, int heads,
                            int ws, int nm, int device, void* stream) {
  if (ws != kWs7) return static_cast<int>(cudaErrorInvalidValue);
  static KernelFacts facts;
  const int smem = static_cast<int>(sizeof(W7Smem));
  int sms = 0, per_sm = 0;
  const cudaError_t err = facts.get(window_attention_w7_kernel, smem,
                                    kW7Threads, device, sms, per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = nW * heads;
  window_attention_w7_kernel<<<std::min(pairs, sms * per_sm), kW7Threads,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      qkv, table, mask, out, pairs, heads, nm,
      static_cast<float>(1.0 / sqrt(static_cast<double>(kD))));
  return static_cast<int>(cudaGetLastError());
}

const char* window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
