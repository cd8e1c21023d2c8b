// Fused Swin block halves, forward only (kernels K2 and K3).
//
// Replace the TPU kernels of mal_tpu/ops/pallas/swin_block.py:
//   K2 swin_attn_fused: per ws x ws window of the padded, rolled residual
//      stream: LayerNorm (eps 1e-6) -> zero the pad tokens -> qkv -> per-head
//      softmax(q k^T d^-1/2 + relative-position bias + shift mask) v -> proj;
//   K3 swin_mlp_fused: LayerNorm -> fc1 -> exact erf GELU -> fc2 -> + residual.
//
// Rounding points, as in the Pallas kernels: LayerNorm in fp32; the normalised
// tokens, the weights, qkv (after its fp32 bias add), the softmax
// probabilities (normalised in fp32 first), the attention output and the GELU
// hidden are each rounded to the compute type (bf16 or fp32); every product
// accumulates in fp32; the residual add is x + acc in fp32, written once in
// the stream's type.
//
// What bounds them on an H100 at Swin-L, 192x640, batch 12: operations. Each
// half is 34-68 GFLOP of bf16 products (0.035-0.07 ms at 989 TFLOP/s) against
// 30-85 MB of stream and parameter traffic (0.01-0.025 ms), at all four
// stages (C = 192 / 384 / 768 / 1536 on 96,768 / 24,192 / 6,912 / 3,456
// padded tokens). So the design keeps the tensor cores fed and keeps
// intermediates out of device memory where a block can hold them.
//
// Design. A Swin-L window does not fit a block's 227 KB at C = 1536 (the
// normalised window alone is 442 KB), so each half is a short chain of this
// file's kernels on one stream, where the Pallas cells keep a window in VMEM:
//   K2 = layernorm_rows (LayerNorm, pad zeroing, rounding) -> cast (both
//        weights, one launch) -> gemm (qkv + bias, rows scattered into window
//        order) -> window_core (softmax(q k^T) v per window and head; writes
//        its output back in stream order) -> gemm (proj + bias, dense A);
//   K3 = layernorm_rows -> cast -> at C <= 256 one fused kernel: per 128
//        tokens, fc1 over 64-wide chunks of the hidden, + bias, GELU, rounded
//        to bf16 in shared memory, and that chunk straight into fc2's
//        accumulator, which stays in registers across the chunks, so the
//        hidden (141.6 MB at stage 0) never reaches device memory; at larger C
//        gemm (fc1 + bias + GELU) -> gemm (fc2 + bias + residual).
// The GEMM (gemm_tma_kernel) is Hopper's: TMA brings 128 x 64 tiles of A and
// 192 x 64 tiles of the bf16 weights (both K-major, nn.Linear's layout,
// 128-byte swizzled) through a ring of 5 shared-memory stages on mbarriers,
// one producer thread issues the loads, and two consumer warpgroups each
// multiply 64 rows with wgmma m64n192k16 (bf16 -> fp32 in registers). The
// tile is 192 wide because every Swin-L width (192, 384, ..., 6144) is a
// multiple of 192, so no product is padded to a wider tile. A block per SM
// walks the tiles, so the producer loads the next tile while the consumers
// finish this one. The consumers stage their sums in shared memory 32
// columns at a time and drain them through the epilogue a row per
// half-warp, with coalesced stores and a small loop: at Swin-L stage 0 an
// epilogue unrolled over each thread's registers, with the GELU and the row
// map inlined at every pair, held the qkv product at 0.75 ms against 0.12 ms
// now. Ragged M, N and K come out of TMA's zero fill. The products run at
// 250-450 TFLOP/s (25-45 % of the peak); neither 256-row tiles (40 % fewer
// L2 bytes per product) nor warpgroups taking whole tiles in turn (each
// one's epilogue under the other's products) moved them by more than ~10 %.
// The attention core is mma.sync m16n8k16 with a warp's 16 x Np scores in
// registers (the probabilities are normalised in fp32 before they are
// rounded, so the softmax is not the online one; the per-score bias, mask,
// exp and division, not the products, are most of its time). A block takes
// one window and a group of heads in two slots of warps, so that the
// window's shift mask is staged in shared memory once for the group, one
// slot's cp.async loads overlap the other's products, and V is read
// transposed by ldmatrix.trans. With 18 warps an SM the compiler holds it to
// 96 registers and it spills ~250 bytes a thread; 9 warps an SM without
// spills measured slower.
// The fp32 compute type keeps a plain FMA tiling (no TF32) and a per-query
// loop for the core.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr float kLnEps = 1e-6f;  // flax.linen.LayerNorm's default
constexpr int kBM = 128;         // block tile rows (both GEMMs)
constexpr int kBN = 128;         // fp32 GEMM: block tile columns
constexpr int kBK = 32;          // fp32 GEMM: block tile depth
constexpr int kThreads = 256;
constexpr int kLdF = kBM + 4;    // fp32 tile row stride (k-major tiles)
constexpr int kD = 32;           // head width

enum Epi { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

// ---------------------------------------------------------------- helpers

// Window partition as a row map: stream row r = (image, y, x) of a
// (B, Hp, Wp) token grid -> row (window, token in window). ws == 0: identity.
struct RowMap {
  int ws, Hp, Wp;
};

__device__ __forceinline__ size_t map_row(const RowMap& rm, int r) {
  if (rm.ws == 0) return static_cast<size_t>(r);
  const int hw = rm.Hp * rm.Wp;
  const int img = r / hw;
  const int pos = r - img * hw;
  const int y = pos / rm.Wp;
  const int x = pos - y * rm.Wp;
  const int win = (img * (rm.Hp / rm.ws) + y / rm.ws) * (rm.Wp / rm.ws) +
                  x / rm.ws;
  const int tok = (y % rm.ws) * rm.ws + x % rm.ws;
  return static_cast<size_t>(win) * rm.ws * rm.ws + tok;
}

// The inverse: token i of window w -> its stream row.
__device__ __forceinline__ size_t stream_row(int w, int i, int ws, int Hp,
                                             int Wp) {
  const int nx = Wp / ws;
  const int per_img = (Hp / ws) * nx;
  const int img = w / per_img;
  const int wi = w - img * per_img;
  const int y = (wi / nx) * ws + i / ws;
  const int x = (wi % nx) * ws + i % ws;
  return (static_cast<size_t>(img) * Hp + y) * Wp + x;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// W consecutive elements from a 16-byte aligned address, as floats.
template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&v)[W]) {
  static_assert(W % 4 == 0, "float rows move as float4");
#pragma unroll
  for (int i = 0; i < W; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x;
    v[i + 1] = a.y;
    v[i + 2] = a.z;
    v[i + 3] = a.w;
  }
}

template <int W>
__device__ __forceinline__ void load_row(const bf16* p, float (&v)[W]) {
  static_assert(W % 8 == 0, "bf16 rows move as uint4");
#pragma unroll
  for (int i = 0; i < W; i += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[i + 2 * j] = f.x;
      v[i + 2 * j + 1] = f.y;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* p, const float (&v)[W]) {
  static_assert(W % 4 == 0, "float rows move as float4");
#pragma unroll
  for (int i = 0; i < W; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int W>
__device__ __forceinline__ void store_row(bf16* p, const float (&v)[W]) {
  static_assert(W % 8 == 0, "bf16 rows move as uint4");
#pragma unroll
  for (int i = 0; i < W; i += 8) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
    *reinterpret_cast<uint4*>(p + i) = a;
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// the first 1024-byte aligned address at or after p (TMA's 128-byte swizzle
// repeats every 1024 bytes, and wgmma reads it from such a base)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ----------------------------------------------------- LayerNorm, weight cast

// y = round_TC(LayerNorm(x) * valid) for every row of x (M, C): two passes in
// fp32 for the mean and the variance as the Pallas _layernorm, a third to
// write. One warp per row, 8 consecutive channels per lane and step; the row
// (at most 6 KB) stays in L1 between the passes. valid: (period) floats, 1 on
// real tokens and 0 on pad tokens, indexed by row % period, or null.
template <typename TS, typename TC>
__global__ void layernorm_rows_kernel(const TS* __restrict__ x,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta,
                                      const float* __restrict__ valid,
                                      int period, int M, int C,
                                      TC* __restrict__ y) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const TS* xr = x + static_cast<size_t>(row) * C;
  float v[8];
  float sum = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    load_row<8>(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / C;
  float sq = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    load_row<8>(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = 1.f / sqrtf(sq / C + kLnEps);
  const float keep = valid ? valid[row % period] : 1.f;
  TC* yr = y + static_cast<size_t>(row) * C;
  for (int c = lane * 8; c < C; c += 256) {
    float g[8], b[8];
    load_row<8>(xr + c, v);
    load_row<8>(gamma + c, g);
    load_row<8>(beta + c, b);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = ((v[i] - mean) * rstd * g[i] + b[i]) * keep;
    store_row<8>(yr + c, v);
  }
}

// Both weights of a half rounded to bf16 in one launch: w0 (n0) then w1 (n1),
// 8 per thread (n0 % 8 == n1 % 8 == 0).
__global__ void cast_bf16_kernel(const float* __restrict__ w0,
                                 bf16* __restrict__ o0, size_t n0,
                                 const float* __restrict__ w1,
                                 bf16* __restrict__ o1, size_t n1) {
  size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  const float* w = w0;
  bf16* o = o0;
  if (i >= n0) {
    i -= n0;
    w = w1;
    o = o1;
    if (i >= n1) return;
  }
  float v[8];
  load_row<8>(w + i, v);
  store_row<8>(o + i, v);
}

// ------------------------------------------------------- the bf16 GEMM

// What happens to a finished bf16-GEMM accumulator pair (row, col..col + 1):
// + bias, then exact erf GELU or not, then + the residual or not, then a
// cast to the output's type and a store to row `orow` = map(row) of `out`.
struct GemmEpi {
  const float* bias;  // (N)
  const void* resid;  // (M, N) in the output's type, or null
  void* out;          // (rows, N)
  RowMap map;
  int gelu;
  int out_bf16;       // out and resid bf16, else fp32
};

__device__ __forceinline__ void epi_pair(const GemmEpi& ep, int N, int row,
                                         size_t orow, int col, float2 b,
                                         float v0, float v1) {
  v0 += b.x;
  v1 += b.y;
  if (ep.gelu) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (ep.resid) {
    const size_t at = static_cast<size_t>(row) * N + col;
    float2 x;
    if (ep.out_bf16)
      x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          static_cast<const bf16*>(ep.resid) + at));
    else
      x = *reinterpret_cast<const float2*>(
          static_cast<const float*>(ep.resid) + at);
    v0 = x.x + v0;
    v1 = x.y + v1;
  }
  const size_t o = orow * N + col;
  if (ep.out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + o) =
        __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + o) =
        make_float2(v0, v1);
}

constexpr int kTmaThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The epilogue stages a warpgroup's sums 32 columns at a time, in an fp32
// tile of this row stride, so that its shared memory stays small beside the
// ring.
constexpr int kOutCols = 32;
constexpr int kOutLd = kOutCols + 4;

// Columns [32 c, 32 c + 32) of a warpgroup's 64 x W accumulators (wgmma's
// layout: thread t holds rows 16 (t / 32) + (t % 32) / 4 and + 8, columns
// 8 j + 2 (t % 4) and + 1) into the staging tile. c is a constant wherever
// this is inlined, so the accumulators stay in registers.
template <int W>
__device__ __forceinline__ void stage_chunk(float* tile,
                                            const float (&acc)[W / 2], int c,
                                            int t) {
  float* rows = tile + (16 * (t / 32) + (t % 32) / 4) * kOutLd + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < kOutCols / 8; ++j) {
    const int a = 4 * (c * kOutCols / 8 + j);
    *reinterpret_cast<float2*>(rows + 8 * j) = make_float2(acc[a], acc[a + 1]);
    *reinterpret_cast<float2*>(rows + 8 * kOutLd + 8 * j) =
        make_float2(acc[a + 2], acc[a + 3]);
  }
}

// A staged 64 x 32 tile (rows m0.., columns n0..) through the epilogue: each
// of the warpgroup's warps takes two rows at a time, half a warp a row and
// lane l the column pair l % 16, so the stores are coalesced, each lane's
// bias is loaded once for all its rows, and the row loop stays small.
// orows: each row's output row.
__device__ __forceinline__ void drain_chunk(const float* tile,
                                            const size_t* orows, int m0,
                                            int n0, int M, int N,
                                            const GemmEpi& ep, int t) {
  const int pair = t % 16;
  const int col = n0 + 2 * pair;
  if (col >= N) return;
  const float2 b = *reinterpret_cast<const float2*>(ep.bias + col);
#pragma unroll 1
  for (int r = (t / 16) % 2 + 2 * (t / 32); r < 64 && m0 + r < M; r += 8) {
    const float2 v =
        *reinterpret_cast<const float2*>(tile + r * kOutLd + 2 * pair);
    epi_pair(ep, N, m0 + r, orows[r], col, b, v.x, v.y);
  }
}

// A warpgroup's 64 x W sums (rows m0.., columns n0..) through the epilogue,
// 32 columns at a time through its staging tile; the rows' output rows (the
// row map: six integer divisions) are found once, into orows (64).
// `barrier` is the warpgroup's named barrier.
template <int W>
__device__ __forceinline__ void epilogue(float* tile, size_t* orows,
                                         const float (&acc)[W / 2], int m0,
                                         int n0, int M, int N,
                                         const GemmEpi& ep, int barrier,
                                         int t) {
#pragma unroll
  for (int c = 0; c < W / kOutCols; ++c) {
    named_sync(barrier, 128);  // the last chunk's drain has read the tile
    if (c == 0 && t < 64 && m0 + t < M) orows[t] = map_row(ep.map, m0 + t);
    stage_chunk<W>(tile, acc, c, t);
    named_sync(barrier, 128);
    drain_chunk(tile, orows, m0, n0 + c * kOutCols, M, N, ep, t);
  }
}

constexpr int kTmaBN = 192;  // bf16 GEMM: block tile columns

struct GemmShape {
  static constexpr int kA = kBM * kRowBytes;      // a 128 x 64 tile of A
  static constexpr int kB = kTmaBN * kRowBytes;   // a 192 x 64 tile of weights
  static constexpr int kStage = kA + kB;
  static constexpr int kStaging = 64 * kOutLd * 4;  // a warpgroup's chunk
  static constexpr int kFixed = 2 * kStaging + 2 * 64 * 8 + 1024;
  static constexpr int kStages =
      std::min(6, (232448 - kFixed - 12 * 8) / kStage);
  static constexpr int kSmem = kStages * kStage + kFixed + 2 * kStages * 8;
  static_assert(kStages >= 3, "the ring needs three stages");
};

// out = epilogue(A @ W^T): A (M, K) and W (N, K) bf16 through the TMA maps
// ta (boxes 64 x 128) and tw (64 x 192). A persistent block per SM walks the
// (128-row, 192-column) tiles, columns fastest. Thread 0 of warpgroup 0
// keeps the ring of stages full across tiles, so the next tile's loads
// overlap this tile's epilogue; warpgroups 1 and 2 multiply rows 0-63 and
// 64-127 of each tile one k-block behind the loads and run the epilogue
// from their registers.
__global__ void __launch_bounds__(kTmaThreads, 1)
    gemm_tma_kernel(__grid_constant__ const CUtensorMap ta,
                    __grid_constant__ const CUtensorMap tw, GemmEpi ep, int M,
                    int N, int K) {
  using S = GemmShape;
  constexpr int BN = kTmaBN;
  extern __shared__ unsigned char gemm_smem[];
  unsigned char* base = align1024(gemm_smem);
  float* staging = reinterpret_cast<float*>(base + S::kStages * S::kStage);
  size_t* orows = reinterpret_cast<size_t*>(staging + 2 * (S::kStaging / 4));
  uint64_t* full = reinterpret_cast<uint64_t*>(orows + 2 * 64);
  uint64_t* empty = full + S::kStages;

  const int nt = (N + BN - 1) / BN;
  const int mt = (M + kBM - 1) / kBM;
  const int tiles = nt * mt;
  const int nkb = (K + kTileK - 1) / kTileK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // both consumer warpgroups' warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&ta);
      tma_prefetch(&tw);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % nt) * BN;
        const int m0 = (tile / nt) * kBM;
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int s = it % S::kStages;
          mbar_wait(&empty[s], ((it / S::kStages) & 1) ^ 1);
          unsigned char* st = base + s * S::kStage;
          mbar_expect_tx(&full[s], S::kStage);
          tma_load(st, &ta, &full[s], kb * kTileK, m0);
          tma_load(st + S::kA, &tw, &full[s], kb * kTileK, n0);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int half = wg - 1;
    const int t = threadIdx.x % 128;
    float* tile_st = staging + half * (S::kStaging / 4);
    size_t* rows = orows + half * 64;
    float acc[BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % nt) * BN;
      const int m0 = (tile / nt) * kBM;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < nkb; ++kb, ++it) {
        const int s = it % S::kStages;
        mbar_wait(&full[s], (it / S::kStages) & 1);
        const unsigned char* st = base + s * S::kStage;
        const uint64_t da = desc_sw128(st + half * 64 * kRowBytes);
        const uint64_t db = desc_sw128(st + S::kA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk)
          wgmma(acc, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait<1>();  // the k-block before this one is done with its stage
        if (prev >= 0 && t % 32 == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && t % 32 == 0) mbar_arrive(&empty[prev]);
      epilogue<BN>(tile_st, rows, acc, m0 + half * 64, n0, M, N, ep, 1 + half,
                   t);
    }
  }
}

// --------------------------------------------- K3 fused at C <= 256 (bf16)

constexpr int kHidChunk = 64;  // hidden units per fc1 -> GELU -> fc2 step

template <int CT>  // C rounded up to 64, 128, 192 or 256: fc2's wgmma width
struct MlpShape {
  static constexpr int kKB = CT / kTileK;               // k-blocks of C
  static constexpr int kY = kKB * kBM * kRowBytes;      // the 128 x CT tokens
  static constexpr int kW1 = kKB * kHidChunk * kRowBytes;  // fc1: 64 x CT
  static constexpr int kW2 = CT * kRowBytes;               // fc2: CT x 64
  static constexpr int kStage = kW1 + kW2;
  static constexpr int kH = 64 * kRowBytes;  // one warpgroup's 64 x 64 GELU
  static constexpr int kStages =
      std::min(4, (216 * 1024 - kY - 2 * kH) / kStage);
  static constexpr int kSmem =
      kY + kStages * kStage + 2 * kH + 1024 + (2 * kStages + 1) * 8;
  static_assert(2 * 64 * kOutLd * 4 + 1024 <= kY + kStages * kStage,
                "the epilogue's staging tiles fit over the tokens and ring");
};

// out = x + (GELU(y w1^T + b1) w2^T + b2) for 128 tokens a block: y (M, C)
// through ty (boxes 64 x 128), w1 (hidden, C) through tw1 (64 x 64), w2
// (C, hidden) through tw2 (64 x CT). The producer loads the block's tokens
// once and streams (w1 chunk, w2 chunk) pairs through the ring; each
// consumer warpgroup, for its 64 tokens and chunk j: fc1 into 32 registers
// (issued one chunk ahead, into the other of two register sets, so that it
// runs under the GELU of the chunk before), + b1, GELU, rounded to bf16 into
// its own 64 x 64 swizzled tile, then fc2 from that tile into its CT / 2
// accumulator registers, which last for the whole hidden. The two
// warpgroups interleave their GELU passes with each other's products.
template <int CT>
__global__ void __launch_bounds__(kTmaThreads, 1)
    mlp_fused_kernel(__grid_constant__ const CUtensorMap ty,
                     __grid_constant__ const CUtensorMap tw1,
                     __grid_constant__ const CUtensorMap tw2,
                     const float* __restrict__ b1, GemmEpi ep, int M, int C,
                     int hidden) {
  using S = MlpShape<CT>;
  extern __shared__ unsigned char mlp_smem[];
  unsigned char* ys = align1024(mlp_smem);
  unsigned char* ring = ys + S::kY;
  unsigned char* hs = ring + S::kStages * S::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * S::kH);
  uint64_t* empty = full + S::kStages;
  uint64_t* yfull = empty + S::kStages;
  float* b1s = reinterpret_cast<float*>(yfull + 1);  // (hidden)

  const int m0 = blockIdx.x * kBM;
  const int chunks = (hidden + kHidChunk - 1) / kHidChunk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // both consumer warpgroups' warps
    }
    mbar_init(yfull, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&ty);
      tma_prefetch(&tw1);
      tma_prefetch(&tw2);
      mbar_expect_tx(yfull, S::kY);
      for (int kb = 0; kb < S::kKB; ++kb)
        tma_load(ys + kb * kBM * kRowBytes, &ty, yfull, kb * kTileK, m0);
      for (int j = 0; j < chunks; ++j) {
        const int s = j % S::kStages;
        mbar_wait(&empty[s], ((j / S::kStages) & 1) ^ 1);
        unsigned char* st = ring + s * S::kStage;
        mbar_expect_tx(&full[s], S::kStage);
        for (int kb = 0; kb < S::kKB; ++kb)
          tma_load(st + kb * kHidChunk * kRowBytes, &tw1, &full[s],
                   kb * kTileK, j * kHidChunk);
        tma_load(st + S::kW1, &tw2, &full[s], j * kHidChunk, 0);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int half = wg - 1;
    const int t = threadIdx.x % 128;
    const int lrow = 16 * (t / 32) + (t % 32) / 4;  // accumulator layout
    const int lcol = 2 * (t % 4);
    unsigned char* hc = hs + half * S::kH;
    const unsigned char* yc = ys + half * 64 * kRowBytes;
    for (int i = threadIdx.x - 128; i < hidden; i += 256) b1s[i] = b1[i];
    named_sync(3, 256);

    float acc2[CT / 2];
#pragma unroll
    for (int i = 0; i < CT / 2; ++i) acc2[i] = 0.f;
    float acc1a[kHidChunk / 2], acc1b[kHidChunk / 2];

    // fc1 of chunk j into a, once its weights have landed
    auto fc1 = [&](float (&a)[kHidChunk / 2], int j) {
      const int s = j % S::kStages;
      mbar_wait(&full[s], (j / S::kStages) & 1);
      const unsigned char* st = ring + s * S::kStage;
#pragma unroll
      for (int i = 0; i < kHidChunk / 2; ++i) a[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < S::kKB; ++kb) {
        const uint64_t da = desc_sw128(yc + kb * kBM * kRowBytes);
        const uint64_t db = desc_sw128(st + kb * kHidChunk * kRowBytes);
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk)
          wgmma(a, da + 2 * kk, db + 2 * kk, 1);
      }
      wgmma_commit();
    };
    // chunk j, whose fc1 sums are in cur: fc1 of chunk j + 1 into nxt, then
    // + b1, GELU and bf16 into this warpgroup's 64 x 64 tile, in the
    // 128-byte swizzle TMA would have written (16-byte chunk c of row r at
    // chunk c ^ (r % 8)), then fc2 from it
    auto step = [&](float (&cur)[kHidChunk / 2], float (&nxt)[kHidChunk / 2],
                    int j) {
      wgmma_wait<0>();  // fc1 of chunk j, fc2 of chunk j - 1
      fence_regs(cur);
      fence_regs(acc2);
      if (j > 0 && t % 32 == 0) mbar_arrive(&empty[(j - 1) % S::kStages]);
      if (j + 1 < chunks) fc1(nxt, j + 1);
#pragma unroll
      for (int q = 0; q < kHidChunk / 8; ++q) {
        const int col = 8 * q + lcol;
        const int hcol = j * kHidChunk + col;
        const float2 b = hcol < hidden
                             ? *reinterpret_cast<const float2*>(b1s + hcol)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lrow + 8 * h;
          const float v0 = gelu_erf(cur[4 * q + 2 * h] + b.x);
          const float v1 = gelu_erf(cur[4 * q + 2 * h + 1] + b.y);
          *reinterpret_cast<__nv_bfloat162*>(
              hc + r * kRowBytes + ((q ^ (r % 8)) * 16) + lcol * 2) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      fence_async_shared();
      named_sync(1 + half, 128);
      wgmma_fence();
      const uint64_t dh = desc_sw128(hc);
      const uint64_t dw =
          desc_sw128(ring + (j % S::kStages) * S::kStage + S::kW1);
#pragma unroll
      for (int kk = 0; kk < kHidChunk / 16; ++kk)
        wgmma(acc2, dh + 2 * kk, dw + 2 * kk, 1);
      wgmma_commit();
    };

    mbar_wait(yfull, 0);
    fc1(acc1a, 0);
    for (int j = 0; j < chunks; j += 2) {
      step(acc1a, acc1b, j);
      if (j + 1 < chunks) step(acc1b, acc1a, j + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc2);
    // both warpgroups are done with the tokens and the ring: stage each
    // one's 64 x CT sums there and drain them through + b2 + x
    named_sync(3, 256);
    float* out_tile = reinterpret_cast<float*>(ys) + half * 64 * kOutLd;
    size_t* orows =
        reinterpret_cast<size_t*>(ys + 2 * 64 * kOutLd * 4) + half * 64;
    epilogue<CT>(out_tile, orows, acc2, m0 + half * 64, 0, M, C, ep, 1 + half,
                 t);
  }
}

// ------------------------------------------------------------ fp32 GEMM

// What happens to a finished fp32 accumulator: + bias, then nothing / exact
// erf GELU / + the residual row, then a store to row map(r) of `out`.
template <int EPI>
struct Epilogue {
  const float* bias;
  const float* resid;  // (M, N), only for kBiasResidual
  float* out;
  int N;
  RowMap map;

  __device__ __forceinline__ void operator()(int row, int col,
                                             float (&v)[4]) const {
    float b[4];
    load_row<4>(bias + col, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] += b[i];
    if constexpr (EPI == kBiasGelu) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = gelu_erf(v[i]);
    }
    if constexpr (EPI == kBiasResidual) {
      float x[4];
      load_row<4>(resid + static_cast<size_t>(row) * N + col, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = x[i] + v[i];
    }
    store_row<4>(out + map_row(map, row) * N + col, v);
  }
};

// The product in plain fp32 (no tensor cores, no TF32): a (M, K) and w fp32,
// 16 x 16 threads, each an 8 x 8 micro-tile of two 4-wide groups per axis,
// tiles k-major in shared memory. K % 32 == 0, N % 4 == 0.
template <int EPI>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    Epilogue<EPI> ep, int M, int N, int K) {
  __shared__ __align__(16) float as[kBK][kLdF];
  __shared__ __align__(16) float bs[kBK][kLdF];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // staging: thread t moves 16 consecutive k of row t / 2 of both tiles
  const int lrow = tid / 2;
  const int lk = (tid % 2) * 16;
  const bool aok = m0 + lrow < M;
  const bool wok = n0 + lrow < N;
  const float* asrc = a + static_cast<size_t>(aok ? m0 + lrow : 0) * K + lk;
  const float* wsrc = w + static_cast<size_t>(wok ? n0 + lrow : 0) * K + lk;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float av[16], bv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) av[i] = bv[i] = 0.f;
    if (aok) load_row<16>(asrc + k0, av);
    if (wok) load_row<16>(wsrc + k0, bv);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      as[lk + i][lrow] = av[i];
      bs[lk + i][lrow] = bv[i];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float x[8], y[8];
      *reinterpret_cast<float4*>(&x[0]) =
          *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      *reinterpret_cast<float4*>(&x[4]) =
          *reinterpret_cast<const float4*>(&as[k][64 + ty * 4]);
      *reinterpret_cast<float4*>(&y[0]) =
          *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      *reinterpret_cast<float4*>(&y[4]) =
          *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (row < M && col < N) {
        float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]};
        ep(row, col, v);
      }
    }
  }
}

// --------------------------------------------------------- attention core

// softmax(q k^T * d^-1/2 + rpb[h] + mask[w % nm]) v for one (window, head)
// per block and one query per thread, on qkv (nW, N, 3C) in the compute type
// T, written in T to the tokens' stream rows of out (B Hp Wp, C). K and V sit
// in shared memory as floats (the conversion is exact); q stays in registers.
// The probabilities must be normalised in fp32 *before* they are rounded to
// T, so the softmax is not the online one of K4: a first pass over the keys
// finds the row maximum and the sum, a second recomputes each score, rounds
// p = e / sum to T and accumulates p v in fp32. The relative-position index
// comes from the token coordinates; the shift mask is symmetric and is read
// by columns, so lanes of consecutive queries read consecutive addresses.
template <typename T>
__global__ void window_core_kernel(const T* __restrict__ qkv,
                                   const float* __restrict__ table,
                                   const float* __restrict__ mask,
                                   T* __restrict__ out, int heads, int ws,
                                   int nm, int Hp, int Wp, float scale) {
  extern __shared__ __align__(16) float core_smem[];
  const int N = ws * ws;
  const int C = heads * kD;
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int span = 2 * ws - 1;

  float* ks = core_smem;       // (N, 32)
  float* vs = ks + N * kD;     // (N, 32)
  float* tab = vs + N * kD;    // span^2

  const T* base = qkv + static_cast<size_t>(w) * N * 3 * C + h * kD;
  for (int idx = threadIdx.x; idx < N * (kD / 8); idx += blockDim.x) {
    const int n = idx / (kD / 8);
    const int g = (idx % (kD / 8)) * 8;
    const T* row = base + static_cast<size_t>(n) * 3 * C + g;
    float kf[8], vf[8];
    load_row<8>(row + C, kf);
    load_row<8>(row + 2 * C, vf);
    store_row<8>(ks + n * kD + g, kf);
    store_row<8>(vs + n * kD + g, vf);
  }
  for (int idx = threadIdx.x; idx < span * span; idx += blockDim.x)
    tab[idx] = table[idx * heads + h];
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= N) return;

  float q[kD];
  load_row<kD>(base + static_cast<size_t>(i) * 3 * C, q);
  const int yi = i / ws;
  const int xi = i - yi * ws;
  // table row of (query i, key j): (yi - yj + ws - 1) * span + xi - xj + ws - 1
  const float* trow = tab + (yi + ws - 1) * span + xi + ws - 1;
  const float* mcol = mask ? mask + static_cast<size_t>(w % nm) * N * N + i
                           : nullptr;

  auto score = [&](int j, int yj, int xj) {
    const float4* kr = reinterpret_cast<const float4*>(ks + j * kD);
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kD / 4; ++g) {
      const float4 k = kr[g];
      s += q[4 * g] * k.x + q[4 * g + 1] * k.y + q[4 * g + 2] * k.z +
           q[4 * g + 3] * k.w;
    }
    float bias = trow[-(yj * span + xj)];
    if (mcol) bias += mcol[static_cast<size_t>(j) * N];
    return s * scale + bias;
  };

  float m = -INFINITY;
  float l = 0.f;
  int yj = 0, xj = 0;
  for (int j = 0; j < N; ++j) {
    const float s = score(j, yj, xj);
    const float mn = fmaxf(m, s);
    l = l * expf(m - mn) + expf(s - mn);  // expf(-inf) = 0 on the first key
    m = mn;
    if (++xj == ws) {
      xj = 0;
      ++yj;
    }
  }

  float acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] = 0.f;
  yj = 0;
  xj = 0;
  for (int j = 0; j < N; ++j) {
    const float s = score(j, yj, xj);
    const float p = to_float(from_float<T>(expf(s - m) / l));
    const float4* vr = reinterpret_cast<const float4*>(vs + j * kD);
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
  store_row<kD>(out + stream_row(w, i, ws, Hp, Wp) * C + h * kD, acc);
}

constexpr int kCoreLd = kD + 8;  // bf16 row stride of Q, K and V (banks)

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8 and receives r[m] of matrix m
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The same core on the tensor cores, for the bf16 compute type, at window
// sizes WS of 7 and 12. One warp per strip of 16 queries; the keys are
// padded to NT tiles of 8 (zero rows, p = 0). A warp holds its whole 16 x
// (8 NT) strip of scores in registers, as the accumulators of mma.sync
// m16n8k16 (lane 4 g + t owns rows g and g + 8, columns 2 t and 2 t + 1 of
// every tile): it adds scale, bias and mask there, reduces max and sum over
// the four lanes of a row by shuffles, and divides. The probabilities are
// rounded to bf16 only after that division, as the Pallas kernel rounds
// them, and two score tiles, as bf16 pairs, then *are* the A operand of one
// 16-key step of p v, whose B operand ldmatrix.trans reads from V stored
// row-major.
// A block takes one window and a group of `group` heads in two slots of
// NT / 2 warps that run on their own (slot s takes heads s, s + 2, ...), so
// one slot's cp.async loads overlap the other's products. The window's
// shift mask is staged in shared memory once for the whole group, beside
// each slot's q, k and v, the group's bias tables and each key's table
// offset. The output goes to the tokens' stream rows.
template <int WS>
struct CoreShape {
  static constexpr int N = WS * WS;
  static constexpr int NT = (N + 15) / 16 * 2;  // key tiles of 8
  static constexpr int Np = NT * 8;
  static constexpr int kSpan = 2 * WS - 1;
  static constexpr int kSlot = NT * 16;         // threads of a slot
  static constexpr int kHead = 3 * Np * kCoreLd;  // bf16 of q, k, v
  static constexpr int kKoff = 2 * kHead * 2;     // byte offsets ...
  static constexpr int kTab = kKoff + Np * 4;
  __host__ __device__ static constexpr int mask_at(int group) {
    return (kTab + group * kSpan * kSpan * 4 + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int smem(int group, bool masked) {
    return mask_at(group) + (masked ? N * (N + 4) * 4 : 0);
  }
};

template <int WS, bool MASKED>
__global__ void __launch_bounds__(CoreShape<WS>::kSlot * 2, 1)
    window_core_mma_kernel(const bf16* __restrict__ qkv,
                           const float* __restrict__ table,
                           const float* __restrict__ mask,
                           bf16* __restrict__ out, int heads, int group,
                           int nm, int Hp, int Wp, float scale) {
  using S = CoreShape<WS>;
  constexpr int N = S::N, NT = S::NT, Np = S::Np, span = S::kSpan;
  constexpr int mld = N + 4;  // fp32 row stride of the staged mask
  extern __shared__ __align__(16) unsigned char core_mma_smem[];
  const int C = heads * kD;
  const int w = blockIdx.x;
  const int h0 = blockIdx.y * group;
  const int slot = threadIdx.x / S::kSlot;
  const int st = threadIdx.x % S::kSlot;
  bf16* qs = reinterpret_cast<bf16*>(core_mma_smem) + slot * S::kHead;
  const bf16* ks = qs + Np * kCoreLd;
  const bf16* vs = ks + Np * kCoreLd;
  int* koff = reinterpret_cast<int*>(core_mma_smem + S::kKoff);
  float* tab = reinterpret_cast<float*>(core_mma_smem + S::kTab);
  float* ms = reinterpret_cast<float*>(core_mma_smem + S::mask_at(group));
  const int warp = st / 32;
  const int lane = st % 32;

  const bf16* base = qkv + static_cast<size_t>(w) * N * 3 * C;
  // q, k and v of head h0 + hh into this slot's buffer; rows past N zeros
  auto fetch = [&](int hh) {
    const bf16* src = base + (h0 + hh) * kD;
    for (int idx = st; idx < Np * 3 * (kD / 8); idx += S::kSlot) {
      const int n = idx / (3 * (kD / 8));
      const int part = (idx / (kD / 8)) % 3;  // 0 q, 1 k, 2 v
      const int g8 = (idx % (kD / 8)) * 8;
      const bool real = n < N;
      cp_async_16(qs + (part * Np + n) * kCoreLd + g8,
                  src + static_cast<size_t>(real ? n : 0) * 3 * C + part * C +
                      g8,
                  real);
    }
    cp_async_commit();
  };

  if (slot < group) fetch(slot);
  if constexpr (MASKED) {
    const float* mw = mask + static_cast<size_t>(w % nm) * N * N;
    if constexpr (N % 4 == 0) {
      for (int idx = threadIdx.x; idx < N * (N / 4); idx += blockDim.x) {
        const int i = idx / (N / 4);
        const int j4 = (idx % (N / 4)) * 4;
        cp_async_16(ms + i * mld + j4, mw + i * N + j4, true);
      }
    } else {
      for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x)
        cp_async_4(ms + (idx / N) * mld + idx % N, mw + idx);
    }
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < group * span * span; idx += blockDim.x)
    tab[idx] = table[(idx % (span * span)) * heads + h0 + idx / (span * span)];
  for (int j = threadIdx.x; j < Np; j += blockDim.x)
    koff[j] = (j / WS) * span + j % WS;
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16;

  for (int hh = slot; hh < group; hh += 2) {
    const float* tb = tab + hh * span * span;

    // scores: s[nt] = the 16 x 8 tile of q k^T at keys 8 nt .. 8 nt + 7
    float s[NT][4];
    {
      unsigned a[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const bf16* q0 = qs + (r0 + g) * kCoreLd + kk * 16 + 2 * t;
        a[kk][0] = *reinterpret_cast<const unsigned*>(q0);
        a[kk][1] = *reinterpret_cast<const unsigned*>(q0 + 8 * kCoreLd);
        a[kk][2] = *reinterpret_cast<const unsigned*>(q0 + 8);
        a[kk][3] = *reinterpret_cast<const unsigned*>(q0 + 8 * kCoreLd + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const bf16* k0 = ks + (nt * 8 + g) * kCoreLd + kk * 16 + 2 * t;
          mma_bf16_16816(s[nt], a[kk], *reinterpret_cast<const unsigned*>(k0),
                         *reinterpret_cast<const unsigned*>(k0 + 8));
        }
      }
    }

    // scale, bias, mask; row max and sum over the row's four lanes; p = e /
    // sum, rounded to bf16 pairs (the A operand's layout) as soon as a row
    // is done, so that half the fp32 scores are dead before the second row
    unsigned pk[2][NT];
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows g and g + 8 of the strip
      const int i = r0 + g + 8 * half;
      const bool real = i < N;
      const int yi = i / WS;
      const int xi = i - yi * WS;
      const float* trow = tb + (yi + WS - 1) * span + xi + WS - 1;
      const float* mrow = ms + (real ? i : 0) * mld;
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * t + e;
          float sc = -INFINITY;
          if (j < N) {
            float bias = real ? trow[-koff[j]] : 0.f;
            if constexpr (MASKED) bias += real ? mrow[j] : 0.f;
            sc = s[nt][2 * half + e] * scale + bias;
          }
          s[nt][2 * half + e] = sc;
          m = fmaxf(m, sc);
        }
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float l = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = expf(s[nt][2 * half + e] - m);
          s[nt][2 * half + e] = ex;
          l += ex;
        }
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        pk[half][nt] =
            pack_bf16(s[nt][2 * half] / l, s[nt][2 * half + 1] / l);
    }

    // out strip 16 x 32 = p v: score tiles 2 kt and 2 kt + 1 are the A
    // operand of the step over keys 16 kt .. 16 kt + 15; ldmatrix.trans
    // gives lane l the B operands of two 8-wide column tiles: matrices of
    // keys +0..7 / +8..15 at dims 8 dn / 8 (dn + 1)
    float o[kD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      const unsigned a[4] = {pk[0][2 * kt], pk[1][2 * kt], pk[0][2 * kt + 1],
                             pk[1][2 * kt + 1]};
#pragma unroll
      for (int dn = 0; dn < kD / 8; dn += 2) {
        unsigned b[4];
        const int key = kt * 16 + ((lane / 8) % 2) * 8 + lane % 8;
        ldmatrix_x4_trans(b, vs + key * kCoreLd + (dn + lane / 16) * 8);
        mma_bf16_16816(o[dn], a, b[0], b[1]);
        mma_bf16_16816(o[dn + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half;
      if (i >= N) continue;
      bf16* orow = out + stream_row(w, i, WS, Hp, Wp) * C + (h0 + hh) * kD +
                   2 * t;
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn)
        *reinterpret_cast<unsigned*>(orow + dn * 8) =
            pack_bf16(o[dn][2 * half], o[dn][2 * half + 1]);
    }
    if (hh + 2 < group) {
      named_sync(1 + slot, S::kSlot);  // the slot is done with this head
      fetch(hh + 2);
      cp_async_wait<0>();
      named_sync(1 + slot, S::kSlot);
    }
  }
}

// ------------------------------------------------------------ host side

#define RETURN_IF_ERROR(expr)               \
  do {                                      \
    const cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// epilogue(a @ w^T) for a (M, K) and w (N, K) bf16 on the Hopper GEMM.
cudaError_t launch_gemm_bf16(const bf16* a, const bf16* w, GemmEpi ep, int M,
                             int N, int K, cudaStream_t stream) {
  using S = GemmShape;
  CUtensorMap ta, tw;
  RETURN_IF_ERROR(make_map(&ta, a, M, K, kBM));
  RETURN_IF_ERROR(make_map(&tw, w, N, K, kTmaBN));
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      gemm_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem));
  const long long tiles = static_cast<long long>((N + kTmaBN - 1) / kTmaBN) *
                          ((M + kBM - 1) / kBM);
  const int grid = static_cast<int>(std::min<long long>(tiles, sm_count()));
  gemm_tma_kernel<<<grid, kTmaThreads, S::kSmem, stream>>>(ta, tw, ep, M, N,
                                                            K);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm_f32(const float* a, const float* w,
                            const Epilogue<EPI>& ep, int M, int N, int K,
                            cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_f32_kernel<EPI><<<grid, kThreads, 0, stream>>>(a, w, ep, M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_cast(const float* w0, bf16* o0, size_t n0, const float* w1,
                        bf16* o1, size_t n1, cudaStream_t stream) {
  const size_t threads = (n0 + n1) / 8;
  cast_bf16_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                     stream>>>(w0, o0, n0, w1, o1, n1);
  return cudaGetLastError();
}

// Heads per block of the tensor-core core: the group whose blocks take the
// least time in whole waves of one block an SM, counted in heads a slot
// runs one after the other; a tie keeps the larger group (fewer mask loads).
int core_group(int windows, int heads) {
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= heads; ++g) {
    if (heads % g) continue;
    const long long blocks = static_cast<long long>(windows) * (heads / g);
    const long long cost =
        (blocks + sm_count() - 1) / sm_count() * ((g + 1) / 2);
    if (best_cost < 0 || cost <= best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

template <int WS, bool MASKED>
cudaError_t launch_core_mma(const bf16* qkv, const float* table,
                            const float* mask, bf16* attn, int windows,
                            int heads, int nm, int Hp, int Wp, float scale,
                            cudaStream_t stream) {
  using S = CoreShape<WS>;
  const int group = core_group(windows, heads);
  const int smem = S::smem(group, MASKED);
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      window_core_mma_kernel<WS, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  window_core_mma_kernel<WS, MASKED>
      <<<dim3(windows, heads / group), 2 * S::kSlot, smem, stream>>>(
          qkv, table, mask, attn, heads, group, nm, Hp, Wp, scale);
  return cudaGetLastError();
}

template <int WS>
cudaError_t launch_window_core_mma(const bf16* qkv, const float* table,
                                   const float* mask, bf16* attn, int windows,
                                   int heads, int nm, int Hp, int Wp,
                                   float scale, cudaStream_t stream) {
  return mask ? launch_core_mma<WS, true>(qkv, table, mask, attn, windows,
                                          heads, nm, Hp, Wp, scale, stream)
              : launch_core_mma<WS, false>(qkv, table, mask, attn, windows,
                                           heads, nm, Hp, Wp, scale, stream);
}

// The attention core of compute type TC on qkv (M / N windows of N tokens),
// written to attn in stream order.
template <typename TC>
cudaError_t launch_window_core(const TC* qkv, const float* table,
                               const float* mask, TC* attn, int M, int heads,
                               int ws, int nm, int Hp, int Wp,
                               cudaStream_t stream) {
  const int N = ws * ws;
  const int span = 2 * ws - 1;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kD)));
  if constexpr (std::is_same<TC, bf16>::value) {
    // the tensor-core core at Swin's window sizes (Swin-L's 12, Swin-T's
    // 7); other windows take the loop
    if (ws == 12)
      return launch_window_core_mma<12>(qkv, table, mask, attn, M / N, heads,
                                        nm, Hp, Wp, scale, stream);
    if (ws == 7)
      return launch_window_core_mma<7>(qkv, table, mask, attn, M / N, heads,
                                       nm, Hp, Wp, scale, stream);
  }
  const size_t smem = (2 * static_cast<size_t>(N) * kD + span * span) *
                      sizeof(float);
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      window_core_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  window_core_kernel<TC><<<dim3(M / N, heads), (N + 31) / 32 * 32, smem,
                           stream>>>(qkv, table, mask, attn, heads, ws, nm,
                                     Hp, Wp, scale);
  return cudaGetLastError();
}

template <typename TS, typename TC>
cudaError_t launch_layernorm(const TS* x, const float* gamma,
                             const float* beta, const float* valid,
                             int period, int M, int C, TC* y,
                             cudaStream_t stream) {
  constexpr int kRows = kThreads / 32;
  layernorm_rows_kernel<TS, TC><<<(M + kRows - 1) / kRows, kThreads, 0,
                                  stream>>>(x, gamma, beta, valid, period, M,
                                            C, y);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the two halves

template <typename TS, typename TC>
cudaError_t attn_half(const void* x_, const float* valid, const float* ln_g,
                      const float* ln_b, const float* wqkv, const float* bqkv,
                      const float* table, const float* mask,
                      const float* wproj, const float* bproj, void* y_,
                      void* w16_, void* qkv_, void* attn_, void* out_, int B,
                      int Hp, int Wp, int C, int heads, int ws, int nm,
                      cudaStream_t stream) {
  const TS* x = static_cast<const TS*>(x_);
  TC* y = static_cast<TC*>(y_);
  TC* qkv = static_cast<TC*>(qkv_);
  TC* attn = static_cast<TC*>(attn_);
  const int M = B * Hp * Wp;
  const RowMap same = {0, 0, 0};
  const RowMap windows = {ws, Hp, Wp};

  RETURN_IF_ERROR((launch_layernorm<TS, TC>(x, ln_g, ln_b, valid, Hp * Wp, M,
                                            C, y, stream)));
  if constexpr (std::is_same<TC, bf16>::value) {
    bf16* wqkv16 = static_cast<bf16*>(w16_);
    bf16* wproj16 = wqkv16 + static_cast<size_t>(3) * C * C;
    const size_t cc = static_cast<size_t>(C) * C;
    RETURN_IF_ERROR(
        launch_cast(wqkv, wqkv16, 3 * cc, wproj, wproj16, cc, stream));
    const GemmEpi e1 = {bqkv, nullptr, qkv, windows, 0, 1};
    RETURN_IF_ERROR(launch_gemm_bf16(y, wqkv16, e1, M, 3 * C, C, stream));
    RETURN_IF_ERROR(launch_window_core<TC>(qkv, table, mask, attn, M, heads,
                                           ws, nm, Hp, Wp, stream));
    const GemmEpi e2 = {bproj, nullptr, out_, same, 0,
                        std::is_same<TS, bf16>::value};
    return launch_gemm_bf16(attn, wproj16, e2, M, C, C, stream);
  } else {
    const Epilogue<kBias> e1 = {bqkv, nullptr, qkv, 3 * C, windows};
    RETURN_IF_ERROR(launch_gemm_f32(y, wqkv, e1, M, 3 * C, C, stream));
    RETURN_IF_ERROR(launch_window_core<TC>(qkv, table, mask, attn, M, heads,
                                           ws, nm, Hp, Wp, stream));
    const Epilogue<kBias> e2 = {bproj, nullptr, static_cast<float*>(out_), C,
                                same};
    return launch_gemm_f32(attn, wproj, e2, M, C, C, stream);
  }
}

constexpr int kFusedMaxC = 256;  // K3 fuses fc1 and fc2 up to this width

template <int CT>
cudaError_t launch_mlp_fused(const bf16* y, const bf16* w1, const float* b1,
                             const bf16* w2, const GemmEpi& ep, int M, int C,
                             int hidden, cudaStream_t stream) {
  CUtensorMap ty, tw1, tw2;
  RETURN_IF_ERROR(make_map(&ty, y, M, C, kBM));
  RETURN_IF_ERROR(make_map(&tw1, w1, hidden, C, kHidChunk));
  RETURN_IF_ERROR(make_map(&tw2, w2, C, hidden, CT));
  const int smem = MlpShape<CT>::kSmem + hidden * 4;  // + b1
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      mlp_fused_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem));
  mlp_fused_kernel<CT><<<(M + kBM - 1) / kBM, kTmaThreads, smem, stream>>>(
      ty, tw1, tw2, b1, ep, M, C, hidden);
  return cudaGetLastError();
}

template <typename TS, typename TC>
cudaError_t mlp_half(const void* x_, const float* ln_g, const float* ln_b,
                     const float* w1, const float* b1, const float* w2,
                     const float* b2, void* y_, void* w16_, void* hidden_,
                     void* out_, int M, int C, int hidden_dim,
                     cudaStream_t stream) {
  const TS* x = static_cast<const TS*>(x_);
  TC* y = static_cast<TC*>(y_);
  TC* hidden = static_cast<TC*>(hidden_);
  const RowMap same = {0, 0, 0};

  RETURN_IF_ERROR((launch_layernorm<TS, TC>(x, ln_g, ln_b, nullptr, 1, M, C,
                                            y, stream)));
  if constexpr (std::is_same<TC, bf16>::value) {
    bf16* w1_16 = static_cast<bf16*>(w16_);
    bf16* w2_16 = w1_16 + static_cast<size_t>(hidden_dim) * C;
    const size_t n_w = static_cast<size_t>(hidden_dim) * C;
    RETURN_IF_ERROR(launch_cast(w1, w1_16, n_w, w2, w2_16, n_w, stream));
    const int out_bf16 = std::is_same<TS, bf16>::value;
    const GemmEpi e2 = {b2, x, out_, same, 0, out_bf16};
    if (C <= kFusedMaxC) {
      if (C <= 64)
        return launch_mlp_fused<64>(y, w1_16, b1, w2_16, e2, M, C, hidden_dim,
                                    stream);
      if (C <= 128)
        return launch_mlp_fused<128>(y, w1_16, b1, w2_16, e2, M, C,
                                     hidden_dim, stream);
      if (C <= 192)
        return launch_mlp_fused<192>(y, w1_16, b1, w2_16, e2, M, C,
                                     hidden_dim, stream);
      return launch_mlp_fused<256>(y, w1_16, b1, w2_16, e2, M, C, hidden_dim,
                                   stream);
    }
    const GemmEpi e1 = {b1, nullptr, hidden, same, 1, 1};
    RETURN_IF_ERROR(launch_gemm_bf16(y, w1_16, e1, M, hidden_dim, C, stream));
    return launch_gemm_bf16(hidden, w2_16, e2, M, C, hidden_dim, stream);
  } else {
    const Epilogue<kBiasGelu> e1 = {b1, nullptr, hidden, hidden_dim, same};
    RETURN_IF_ERROR(launch_gemm_f32(y, w1, e1, M, hidden_dim, C, stream));
    const Epilogue<kBiasResidual> e2 = {b2, x, static_cast<float*>(out_), C,
                                        same};
    return launch_gemm_f32(hidden, w2, e2, M, C, hidden_dim, stream);
  }
}

}  // namespace

extern "C" {

// K3's hidden buffer in elements of the compute type: none where fc1 and fc2
// are fused.
long long swin_mlp_hidden(int M, int C, int hidden, int compute_bf16) {
  return compute_bf16 && C <= kFusedMaxC
             ? 0
             : static_cast<long long>(M) * hidden;
}

// K2. x, out: (B, Hp, Wp, C) in the stream's type (bf16 if stream_bf16 else
// fp32), Hp and Wp multiples of ws; valid: (Hp, Wp) fp32; ln_g, ln_b: (C);
// wqkv: (3C, C), bqkv: (3C), wproj: (C, C), bproj: (C), all fp32; table:
// ((2 ws - 1)^2, heads); mask: (nm, N, N) symmetric shift mask or null.
// Scratch, in the compute type (bf16 if compute_bf16 else fp32): y and attn
// (B Hp Wp, C), qkv (B Hp Wp, 3C); w16: 4 C^2 bf16 for the rounded weights
// (unused and may be null with the fp32 compute type). C = heads * 32,
// ws <= 16; a bf16 stream needs the bf16 compute type. Every pointer 16-byte
// aligned, all on the device.
// Launches on `stream` and returns the first CUDA error, or 0.
int swin_attn_fused(const void* x, const float* valid, const float* ln_g,
                    const float* ln_b, const float* wqkv, const float* bqkv,
                    const float* table, const float* mask, const float* wproj,
                    const float* bproj, void* y, void* w16, void* qkv,
                    void* attn, void* out, int B, int Hp, int Wp, int C,
                    int heads, int ws, int nm, int stream_bf16,
                    int compute_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != heads * kD || ws < 1 || ws > 16 || Hp % ws || Wp % ws ||
      (stream_bf16 && !compute_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto half = compute_bf16 ? (stream_bf16 ? attn_half<bf16, bf16>
                                          : attn_half<float, bf16>)
                           : attn_half<float, float>;
  return static_cast<int>(half(x, valid, ln_g, ln_b, wqkv, bqkv, table, mask,
                               wproj, bproj, y, w16, qkv, attn, out, B, Hp, Wp,
                               C, heads, ws, nm, st));
}

// K3. x, out: (M, C) in the stream's type; ln_g, ln_b: (C); w1: (hidden, C),
// b1: (hidden), w2: (C, hidden), b2: (C), all fp32. Scratch in the compute
// type: y (M, C), hidden_buf: swin_mlp_hidden elements (may be null when
// that is 0); w16: 2 hidden C bf16 (as above). C % 32 == 0,
// hidden % 32 == 0; types and alignment as swin_attn_fused.
int swin_mlp_fused(const void* x, const float* ln_g, const float* ln_b,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, void* y, void* w16, void* hidden_buf,
                   void* out, int M, int C, int hidden, int stream_bf16,
                   int compute_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % kBK || hidden % kBK || (stream_bf16 && !compute_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto half = compute_bf16 ? (stream_bf16 ? mlp_half<bf16, bf16>
                                          : mlp_half<float, bf16>)
                           : mlp_half<float, float>;
  return static_cast<int>(half(x, ln_g, ln_b, w1, b1, w2, b2, y, w16,
                               hidden_buf, out, M, C, hidden, st));
}

const char* swin_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
