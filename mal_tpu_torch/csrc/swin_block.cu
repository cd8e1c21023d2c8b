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
// accumulates in fp32; K3's residual add is x + acc in fp32, written once in
// the stream's type.
//
// What bounds them on an H100 at Swin-L, 192x640, batch 12: operations. A
// block at stage 0 (96,768 padded tokens, C = 192) is 28.5 GFLOP of qkv /
// proj products plus 11 GFLOP of attention for K2 and 54 GFLOP for K3,
// against about 75 MB of stream traffic each: 0.03-0.06 ms of bf16 tensor
// time, 0.02 ms of memory time.
//
// Design. The Pallas cells keep a whole window's tokens,
// qkv and fp32 projection accumulator in ~13 MB of VMEM and stream head
// groups through it. A Hopper block has 227 KB of shared memory, and at
// C = 1536 the normalised window alone is 442 KB, so each half is a short
// chain of this file's own kernels on one stream, and the intermediates (the
// normalised tokens, qkv, the attention output, the GELU hidden) cross device
// memory in the compute type, which is where the Pallas kernels round them:
//   K2 = layernorm_rows (LayerNorm, pad zeroing, rounding) -> gemm<+bias>
//        (qkv, rows written in window order) -> window_core (softmax(q k^T) v
//        per window and head: on the tensor cores in bf16, a loop on the fp32
//        pipes in fp32) -> gemm<rows read in window order, +bias> (proj);
//   K3 = layernorm_rows -> gemm<+bias, GELU> (fc1) -> gemm<+bias, +residual>
//        (fc2).
// The window partition and its reverse are row maps inside the two K2 GEMMs
// (the qkv GEMM scatters whole rows, the proj GEMM gathers them), never copy
// passes. One tiled GEMM routine serves all four products: a 128 x 128 x 32
// block tile, 8 warps of 64 x 32, bf16 operands through nvcuda::wmma
// m16n16k16 with fp32 accumulators, fed by cp.async through a ring of four
// shared-memory tiles, two blocks to an SM. Normalising and casting operands
// in registers on the way into shared memory holds the tensor cores up (59
// TFLOP/s measured, at one block an SM), so the LayerNorm is a pass of its own
// (one more trip of the normalised tokens through device memory, in the
// compute type) and the weights, which nn.Linear holds as fp32
// (out_features, in_features), are rounded to bf16 by
// a small cast kernel before each product. The fp32 compute type runs the
// same tiling with plain FMAs on the fp32 weights (TF32 is not used). The TPU
// kernels' VMEM planners (_attn_plan, _mlp_plan) are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;  // flax.linen.LayerNorm's default
constexpr int kBM = 128;         // block tile rows
constexpr int kBN = 128;         // block tile columns
constexpr int kBK = 32;          // block tile depth
constexpr int kStages = 4;       // shared-memory tiles in flight (bf16 GEMM)
constexpr int kThreads = 256;
constexpr int kLdH = kBK + 8;    // bf16 tile row stride (bank padding)
constexpr int kLdF = kBM + 4;    // fp32 tile row stride (k-major tiles)
constexpr int kPatchLd = 20;     // epilogue staging row stride, floats
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

// fp32 parameters rounded to bf16, 8 per thread (n % 8 == 0).
__global__ void cast_bf16_kernel(const float* __restrict__ w,
                                 bf16* __restrict__ out, size_t n) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x)
                   * 8;
  if (i >= n) return;
  float v[8];
  load_row<8>(w + i, v);
  store_row<8>(out + i, v);
}

// ---------------------------------------------------------------- epilogue

// What happens to a finished accumulator: + bias, then nothing / exact erf
// GELU / + the residual row, then a cast and a store to row map(r) of `out`.
template <int EPI, typename TO, typename TR>
struct Epilogue {
  const float* bias;
  const TR* resid;  // (M, N), only for kBiasResidual
  TO* out;
  int N;
  RowMap map;

  template <int W>
  __device__ __forceinline__ void operator()(int row, int col,
                                             float (&v)[W]) const {
    float b[W];
    load_row<W>(bias + col, b);
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] += b[i];
    if constexpr (EPI == kBiasGelu) {
#pragma unroll
      for (int i = 0; i < W; ++i)
        v[i] = 0.5f * v[i] * (1.f + erff(v[i] * 0.70710678118654752f));
    }
    if constexpr (EPI == kBiasResidual) {
      float x[W];
      load_row<W>(resid + static_cast<size_t>(row) * N + col, x);
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] = x[i] + v[i];
    }
    store_row<W>(out + map_row(map, row) * N + col, v);
  }
};

// ------------------------------------------------------------------- GEMMs

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool real) {
  // 16 bytes global -> shared without passing registers; `real` false
  // writes zeros (source size 0) and reads nothing
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = real ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out = epilogue(A @ w^T): a (rows, K) bf16, row r of the product reading row
// amap(r) of it; w (N, K) bf16, nn.Linear's layout; bf16 operands on the
// tensor cores (wmma m16n16k16), fp32 accumulation. K % 32 == 0, N % 8 == 0.
// Block tile 128 x 128 x 32, 8 warps of 64 x 32, operands brought in by
// cp.async through a ring of kStages shared-memory tiles, so that loads of
// later tiles are in flight while a tile is multiplied.
template <int EPI, typename TO, typename TR>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_bf16_kernel(const bf16* __restrict__ a, RowMap amap,
                     const bf16* __restrict__ w, Epilogue<EPI, TO, TR> ep,
                     int M, int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  // [stage][A | B][row][k]
  bf16* tiles = reinterpret_cast<bf16*>(gemm_smem);
  constexpr int kTile = kBM * kLdH;  // elements of one operand's tile

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;  // 0..1: 64 rows each
  const int wn = warp % 4;  // 0..3: 32 columns each
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // a tile is 128 rows of 4 chunks of 16 bytes: thread t brings chunks t and
  // t + 256 of each operand, rows t / 4 and t / 4 + 64
  const int crow = tid / 4;
  const int ck = (tid % 4) * 8;
  const bf16* asrc[2];
  const bf16* wsrc[2];
  bool aok[2], wok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = crow + 64 * i;
    aok[i] = m0 + r < M;
    wok[i] = n0 + r < N;
    asrc[i] = a + (aok[i] ? map_row(amap, m0 + r) : 0) * K + ck;
    wsrc[i] = w + static_cast<size_t>(wok[i] ? n0 + r : 0) * K + ck;
  }
  auto load_tile = [&](int stage, int k0) {
    bf16* at = tiles + stage * 2 * kTile;
    bf16* bt = at + kTile;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (crow + 64 * i) * kLdH + ck;
      cp_async_16(at + off, asrc[i] + k0, aok[i]);
      cp_async_16(bt + off, wsrc[i] + k0, wok[i]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (for this thread)
    __syncthreads();               // ... for all, and tile kt - 1 is idle
    const int next = kt + kStages - 1;
    if (next < nk) load_tile(next % kStages, next * kBK);
    cp_async_commit();
    const bf16* as = tiles + (kt % kStages) * 2 * kTile + (wm * 64) * kLdH;
    const bf16* bs = tiles + (kt % kStages) * 2 * kTile + kTile +
                     (wn * 32) * kLdH;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + (j * 16) * kLdH + kk, kLdH);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, as + (i * 16) * kLdH + kk, kLdH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: each warp stages one 16 x 16 accumulator at a time in its own
  // patch of the (now idle) tile memory; a lane then owns 8 consecutive
  // columns of one row
  float* patch = reinterpret_cast<float*>(gemm_smem) + warp * 16 * kPatchLd;
  const int prow = lane / 2;
  const int pcol = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], kPatchLd, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 64 + i * 16 + prow;
      const int col = n0 + wn * 32 + j * 16 + pcol;
      if (row < M && col < N) {
        float v[8];
        load_row<8>(patch + prow * kPatchLd + pcol, v);
        ep.template operator()<8>(row, col, v);
      }
      __syncwarp();
    }
  }
}

// The same product in plain fp32 (no tensor cores, no TF32): a and w fp32,
// 16 x 16 threads, each an 8 x 8 micro-tile of two 4-wide groups per axis,
// tiles k-major in shared memory. K % 32 == 0, N % 4 == 0.
template <int EPI>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const float* __restrict__ a, RowMap amap,
                    const float* __restrict__ w,
                    Epilogue<EPI, float, float> ep, int M, int N, int K) {
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
  const float* asrc = a + (aok ? map_row(amap, m0 + lrow) : 0) * K + lk;
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
        ep.template operator()<4>(row, col, v);
      }
    }
  }
}

// A (rows, K) in TC through `amap`, times w (N, K): TC = bf16 takes `w16`,
// the bf16 copy of the weights, TC = float the fp32 parameters themselves.
template <typename TC, int EPI, typename TO, typename TR>
cudaError_t launch_gemm(const TC* a, RowMap amap, const float* w,
                        const bf16* w16, const Epilogue<EPI, TO, TR>& ep,
                        int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if constexpr (std::is_same<TC, bf16>::value) {
    constexpr int smem = kStages * 2 * kBM * kLdH * sizeof(bf16);
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel<EPI, TO, TR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gemm_bf16_kernel<EPI, TO, TR>
        <<<grid, kThreads, smem, stream>>>(a, amap, w16, ep, M, N, K);
  } else {
    gemm_f32_kernel<EPI><<<grid, kThreads, 0, stream>>>(a, amap, w, ep, M, N, K);
  }
  return cudaGetLastError();
}

// The fp32 parameters w (n) as the GEMMs of compute type TC take them: for
// bf16 a rounded copy in `w16`, for fp32 nothing to do.
template <typename TC>
cudaError_t prepare_weights(const float* w, bf16* w16, size_t n,
                            cudaStream_t stream) {
  if constexpr (std::is_same<TC, bf16>::value) {
    const size_t threads = n / 8;
    cast_bf16_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                       stream>>>(w, w16, n);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// --------------------------------------------------------- attention core

// softmax(q k^T * d^-1/2 + rpb[h] + mask[w % nm]) v for one (window, head)
// per block and one query per thread, on qkv (nW, N, 3C) in the compute type
// T, written as (nW, N, C) in T. K and V sit in shared memory as floats (the
// conversion is exact); q stays in registers. The probabilities must be
// normalised in fp32 *before* they are rounded to T, so the softmax is not
// the online one of K4: a first pass over the keys finds the row maximum and
// the sum, a second recomputes each score, rounds p = e / sum to T and
// accumulates p v in fp32. The relative-position index comes from the token
// coordinates; the shift mask is symmetric and is read by columns, so lanes of
// consecutive queries read consecutive addresses.
template <typename T>
__global__ void window_core_kernel(const T* __restrict__ qkv,
                                   const float* __restrict__ table,
                                   const float* __restrict__ mask,
                                   T* __restrict__ out, int heads, int ws,
                                   int nm, float scale) {
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
  store_row<kD>(out + (static_cast<size_t>(w) * N + i) * C + h * kD, acc);
}

// The same core on the tensor cores, for the bf16 compute type: the one above
// spends ~1 ms a launch on the fp32 pipes at Swin-L's stage 0. One block per
// (window, head), one warp per strip of 16 queries; the keys are padded to
// NT tiles of 8 (zero rows, p = 0). A warp holds its whole 16 x (8 NT) strip
// of scores in registers, as the accumulators of mma.sync m16n8k16 (lane
// 4 g + t owns rows g and g + 8, columns 2 t and 2 t + 1 of every tile): it
// adds scale, bias and mask there, reduces max and sum over the four lanes
// of a row by shuffles, and divides. The probabilities are rounded to bf16
// only after that division, as the Pallas kernel rounds them, and two score
// tiles then *are* the A operand of one 16-key step of p v, so nothing is
// staged. Shared memory holds Q and K row-major, V transposed (both B
// operands then read two consecutive bf16 per register), the bias table and
// each key's table offset: 37 KB, and registers capped for two blocks an SM,
// because occupancy sets this kernel's time (staging the scores through 166
// KB of shared memory, one block an SM, measured slower than the fp32 loop).
constexpr int kCoreLd = kD + 8;   // bf16 row stride of Q and K (bank padding)

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int NT>  // key tiles of 8: 8 NT >= N, NT even, one warp per 16 rows
__global__ void __launch_bounds__(NT * 16, 2)
    window_core_mma_kernel(const bf16* __restrict__ qkv,
                           const float* __restrict__ table,
                           const float* __restrict__ mask,
                           bf16* __restrict__ out, int heads, int ws, int nm,
                           float scale) {
  constexpr int Np = NT * 8;
  constexpr int kVLd = Np + 8;  // bf16 row stride of V transposed
  __shared__ __align__(16) bf16 qs[Np * kCoreLd];
  __shared__ __align__(16) bf16 ks[Np * kCoreLd];
  __shared__ __align__(16) bf16 vt[kD * kVLd];
  __shared__ float tab[31 * 31];   // (2 ws - 1)^2 at ws <= 16
  __shared__ int koff[Np];         // key j's offset into a table row

  const int N = ws * ws;
  const int C = heads * kD;
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int span = 2 * ws - 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const bf16* base = qkv + static_cast<size_t>(w) * N * 3 * C + h * kD;
  for (int idx = threadIdx.x; idx < Np * 3 * (kD / 8); idx += blockDim.x) {
    const int n = idx / (3 * (kD / 8));
    const int part = (idx / (kD / 8)) % 3;          // 0 q, 1 k, 2 v
    const int g8 = (idx % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);         // zero rows past N
    if (n < N)
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<size_t>(n) * 3 * C + part * C + g8);
    if (part < 2) {
      *reinterpret_cast<uint4*>((part ? ks : qs) + n * kCoreLd + g8) = val;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(g8 + i) * kVLd + n] = e[i];
    }
  }
  for (int idx = threadIdx.x; idx < span * span; idx += blockDim.x)
    tab[idx] = table[idx * heads + h];
  for (int j = threadIdx.x; j < Np; j += blockDim.x)
    koff[j] = (j / ws) * span + j % ws;
  __syncthreads();

  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16;

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
        const unsigned b[2] = {*reinterpret_cast<const unsigned*>(k0),
                               *reinterpret_cast<const unsigned*>(k0 + 8)};
        mma_bf16_16816(s[nt], a[kk], b);
      }
    }
  }

  // scale, bias, mask; row max and sum over the row's four lanes; p = e / sum
#pragma unroll
  for (int half = 0; half < 2; ++half) {   // rows g and g + 8 of the strip
    const int i = r0 + g + 8 * half;
    const bool real = i < N;
    const int yi = i / ws;
    const int xi = i - yi * ws;
    const float* trow = tab + (yi + ws - 1) * span + xi + ws - 1;
    const float* mrow = (mask && real)
                            ? mask + (static_cast<size_t>(w % nm) * N + i) * N
                            : nullptr;
    float m = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * t + e;
        float sc = -INFINITY;
        if (j < N) {
          float bias = real ? trow[-koff[j]] : 0.f;
          if (mrow) bias += mrow[j];
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
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][2 * half] = s[nt][2 * half] / l;
      s[nt][2 * half + 1] = s[nt][2 * half + 1] / l;
    }
  }

  // out strip 16 x 32 = p v: score tiles 2 kt and 2 kt + 1 are the A operand
  // of the step over keys 16 kt .. 16 kt + 15
  float o[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
    const unsigned a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                           pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                           pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                           pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const bf16* v0 = vt + (dn * 8 + g) * kVLd + kt * 16 + 2 * t;
      const unsigned b[2] = {*reinterpret_cast<const unsigned*>(v0),
                             *reinterpret_cast<const unsigned*>(v0 + 8)};
      mma_bf16_16816(o[dn], a, b);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + g + 8 * half;
    if (i >= N) continue;
    bf16* orow = out + (static_cast<size_t>(w) * N + i) * C + h * kD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      *reinterpret_cast<unsigned*>(orow + dn * 8) =
          pack_bf16(o[dn][2 * half], o[dn][2 * half + 1]);
  }
}

template <int NT>
cudaError_t launch_window_core_mma(const bf16* qkv, const float* table,
                                   const float* mask, bf16* attn, dim3 grid,
                                   int heads, int ws, int nm, float scale,
                                   cudaStream_t stream) {
  window_core_mma_kernel<NT><<<grid, NT * 16, 0, stream>>>(
      qkv, table, mask, attn, heads, ws, nm, scale);
  return cudaGetLastError();
}

// The attention core of compute type TC on qkv (M / N windows of N tokens).
template <typename TC>
cudaError_t launch_window_core(const TC* qkv, const float* table,
                               const float* mask, TC* attn, int M, int heads,
                               int ws, int nm, cudaStream_t stream) {
  const int N = ws * ws;
  const int span = 2 * ws - 1;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kD)));
  const dim3 grid(M / N, heads);
  if constexpr (std::is_same<TC, bf16>::value) {
    // the tensor-core core, at the padded window sizes it is built for
    // (ws = 12: 144 keys; ws = 7 or 8: 64); other windows take the loop
    const int padded = (N + 15) / 16 * 16;
    if (padded == 144)
      return launch_window_core_mma<18>(qkv, table, mask, attn, grid, heads,
                                        ws, nm, scale, stream);
    if (padded == 64)
      return launch_window_core_mma<8>(qkv, table, mask, attn, grid, heads,
                                       ws, nm, scale, stream);
  }
  const size_t smem = (2 * static_cast<size_t>(N) * kD + span * span) *
                      sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      window_core_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  window_core_kernel<TC><<<grid, (N + 31) / 32 * 32, smem, stream>>>(
      qkv, table, mask, attn, heads, ws, nm, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the two halves

#define RETURN_IF_ERROR(expr)               \
  do {                                      \
    const cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

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
  bf16* wqkv16 = static_cast<bf16*>(w16_);
  bf16* wproj16 = wqkv16 + static_cast<size_t>(3) * C * C;
  TC* qkv = static_cast<TC*>(qkv_);
  TC* attn = static_cast<TC*>(attn_);
  TS* out = static_cast<TS*>(out_);
  const int M = B * Hp * Wp;
  const RowMap same = {0, 0, 0};
  const RowMap windows = {ws, Hp, Wp};

  RETURN_IF_ERROR((launch_layernorm<TS, TC>(x, ln_g, ln_b, valid, Hp * Wp, M,
                                            C, y, stream)));
  const size_t cc = static_cast<size_t>(C) * C;
  RETURN_IF_ERROR(prepare_weights<TC>(wqkv, wqkv16, 3 * cc, stream));
  RETURN_IF_ERROR(prepare_weights<TC>(wproj, wproj16, cc, stream));

  Epilogue<kBias, TC, float> e1 = {bqkv, nullptr, qkv, 3 * C, windows};
  RETURN_IF_ERROR(
      launch_gemm<TC>(y, same, wqkv, wqkv16, e1, M, 3 * C, C, stream));

  RETURN_IF_ERROR(launch_window_core<TC>(qkv, table, mask, attn, M, heads, ws,
                                         nm, stream));

  Epilogue<kBias, TS, float> e2 = {bproj, nullptr, out, C, same};
  return launch_gemm<TC>(attn, windows, wproj, wproj16, e2, M, C, C, stream);
}

template <typename TS, typename TC>
cudaError_t mlp_half(const void* x_, const float* ln_g, const float* ln_b,
                     const float* w1, const float* b1, const float* w2,
                     const float* b2, void* y_, void* w16_, void* hidden_,
                     void* out_, int M, int C, int hidden_dim,
                     cudaStream_t stream) {
  const TS* x = static_cast<const TS*>(x_);
  TC* y = static_cast<TC*>(y_);
  bf16* w1_16 = static_cast<bf16*>(w16_);
  bf16* w2_16 = w1_16 + static_cast<size_t>(hidden_dim) * C;
  TC* hidden = static_cast<TC*>(hidden_);
  TS* out = static_cast<TS*>(out_);
  const RowMap same = {0, 0, 0};
  const size_t n_w = static_cast<size_t>(hidden_dim) * C;

  RETURN_IF_ERROR((launch_layernorm<TS, TC>(x, ln_g, ln_b, nullptr, 1, M, C,
                                            y, stream)));
  RETURN_IF_ERROR(prepare_weights<TC>(w1, w1_16, n_w, stream));
  RETURN_IF_ERROR(prepare_weights<TC>(w2, w2_16, n_w, stream));

  Epilogue<kBiasGelu, TC, float> e1 = {b1, nullptr, hidden, hidden_dim, same};
  RETURN_IF_ERROR(
      launch_gemm<TC>(y, same, w1, w1_16, e1, M, hidden_dim, C, stream));

  Epilogue<kBiasResidual, TS, TS> e2 = {b2, x, out, C, same};
  return launch_gemm<TC>(hidden, same, w2, w2_16, e2, M, C, hidden_dim, stream);
}

}  // namespace

extern "C" {

// K2. x, out: (B, Hp, Wp, C) in the stream's type (bf16 if stream_bf16 else
// fp32), Hp and Wp multiples of ws; valid: (Hp, Wp) fp32; ln_g, ln_b: (C);
// wqkv: (3C, C), bqkv: (3C), wproj: (C, C), bproj: (C), all fp32; table:
// ((2 ws - 1)^2, heads); mask: (nm, N, N) symmetric shift mask or null.
// Scratch, in the compute type (bf16 if compute_bf16 else fp32): y and attn
// (B Hp Wp, C), qkv (B Hp Wp, 3C); w16: 4 C^2 bf16 for the rounded weights
// (unused and may be null with the fp32 compute type). C = heads * 32,
// ws <= 16; a bf16 stream needs the bf16 compute type. Every pointer 16-byte
// aligned, all on the device. Launches on `stream` and returns the first CUDA
// error, or 0.
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
// type: y (M, C), hidden_buf (M, hidden); w16: 2 hidden C bf16 (as above).
// C % 32 == 0, hidden % 32 == 0; types and alignment as swin_attn_fused.
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
