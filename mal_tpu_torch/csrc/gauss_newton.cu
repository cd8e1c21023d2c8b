// Gauss-Newton normal equations of DualRefine's feature-metric pose step,
// forward and backward.
//
// Replaces no TPU kernel: mal_tpu/dualref/pose_update.py:direct_align
// leaves these products to XLA (no pallas_call), and the port's first
// version left them to PyTorch: a batched (C x 2) @ (2 x 6) product that
// wrote the (B, N, C, 6) Jacobian J, its weighted copy JW, and two einsums
// that cuBLAS ran as skinny GEMMs (gemmSN). At DualRefine's KITTI shape
// (B 12, C 64, N = 48 x 160) J and JW are 141.6 MB each, written and read
// back eight times a training step, plus the backward's.
//
// For a batch element b, with f (B, C, 5, N) the target features sampled at
// each pixel's projection (plane 0) and at its +-1 pixel neighbours (planes
// 1-4), src (B, C, N), the pixel Jacobian Jp (B, N, 2, 6) and the weight
// w (B, N), every (pixel n, channel c) gives
//     g = ((f1 - f2) / 2, (f3 - f4) / 2),   r = src - f0,
//     j = -(g_x Jp[n][0] + g_y Jp[n][1])    (6 entries),
// and the kernel returns
//     H = sum_{n,c} w_n j j^T   (B, 6, 6),
//     b = -sum_{n,c} w_n j r    (B, 6).
//
// Order of summation. The forward rounds every product and adds every term
// in the order the plain version's cuBLAS calls take at DualRefine's cell
// shape (mal_tpu_torch/ops/cuda/gauss_newton.py:normal_equations_reference,
// which is also the frozen reference the cell is compared with), so there
// it gives the plain version's H and b to the bit. Any other order, exact
// fp64 included, moves H and b by fp32 rounding (~1e-7), and DualRefine's
// Anderson-mixed DEQ solve (its 6 x 6 least squares, lam 1e-4) and the
// Gauss-Newton solve carry that into the refinement net's gradients at
// ~1e-3 to 1e-2 relative: outside the cell's limits on grad_gap,
// grad_median_gap and grad_norm_gap.refinement. The order, as triplet
// probes (2^24, 1, -2^24 at three elements) and bit-for-bit emulation on an
// H100 with cuBLAS 12.8 showed it:
// - H (gemmSN_NN over K = N C, element e = n C + c): lane e mod 64 sums
//   each 16384-element chunk of K in ascending e by fused multiply-adds
//   from 0; a running sum adds, for lanes 0-31 in order, each lane's chunk
//   sums in chunk order; another does lanes 32-63; H is the first plus the
//   second. H is not symmetric to the bit: w j_k j_l and w j_l j_k round
//   apart, as in the plain version.
// - b (gemv over e' = c N + n): lane e' mod 32 sums its elements in
//   ascending e' by fused multiply-adds from 0, then a shuffle tree with
//   offsets 16, 8, 4, 2, 1 adds the 32 lanes.
// - J = -(g_x Jp[0] + g_y Jp[1]) is one fused multiply-add onto the
//   rounded g_x Jp[0]; w j and r are single roundings.
// At other shapes the same rules give a fixed order of the same fp32
// terms; cuBLAS may take another there.
//
// What bounds it on an H100: bytes. A forward call reads f once (118 MB at
// the shape above), src (23.6 MB), Jp and w (4.8 MB): ~146 MB, ~44 us at
// 3.35 TB/s. Its arithmetic, ~50 fp32 operations a (pixel, channel), is
// ~0.3 GFLOP, ~5 us on the 67 TFLOP/s non-tensor pipes. The backward reads
// the same and writes the gradients of f and src (141.6 MB): ~288 MB, ~86 us.
// What keeps the forward above that bound is the order: b is 32 chains of
// 15360 dependent fused multiply-adds a (batch element, k), and H's fold
// 1920 dependent adds.
//
// Design. J and JW never reach device memory: each thread forms j for its
// pixel and channels in registers from the five samples and the pixel's
// 2 x 6 Jp.
// - H: a block is one chunk of one batch element, thread (lane, k) its
//   lane's six sums of row k. The block stages g of 2048 elements at a time
//   in shared memory, loaded from f coalesced along N; at C = 64 a lane is
//   a channel, a chunk 256 pixels, and the 64 lanes of a step read one
//   pixel's Jp. The chunk sums (3.3 MB at the cell's shape) go to a scratch
//   buffer, and a second kernel (a thread an entry and half) folds them.
// - b: a block is (k, batch element); its 32 warps form w j_k and r of 8192
//   consecutive elements into shared memory (coalesced along N), and warp
//   0 runs the 32 lane sums over it while the others form the next tile.
// - Backward: given dH and db, with S = dH + dH^T, each (pixel, channel)
//   recomputes j and r and takes
//       dj = w (S j - r db),  dr = -w (j . db),  dg = -Jp dj,
//   writes df (plane 0: -dr; planes 1-4: +-dg / 2) and dsrc = dr, and adds
//   -g_a dj_k to dJp[n][a][k] and j^T dH j - r (j . db) to dw[n]. The four
//   channel groups of a pixel are threads of one block, which fold their
//   13 sums in a fixed order: no cross-block reduction.
// No atomics: two launches give the same bits. No kernel allocates,
// synchronises or reads anything back to the host.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kPixels = 64;                  // backward: pixels of a block
constexpr int kGroups = 4;                   // backward: channel groups
constexpr int kThreads = kPixels * kGroups;  // 256
constexpr int kLanes = 64;                   // H: lanes of the chunk sums
constexpr int kHalf = kLanes / 2;            // H: lanes a half folds
constexpr int kChunk = kLanes * 256;         // H: elements of a chunk
constexpr int kSub = 2048;                   // H: elements staged at once
constexpr int kStage = 4160;                 // H: staged floats a plane, at
                                             // least (2047 / C + 2) (C + 1)
                                             // for C <= 2048
constexpr int kBThreads = 1024;              // b: threads of a block
constexpr int kBTile = 8192;                 // b: elements of a tile
constexpr int kBSmem = 4 * kBTile * 4;       // b: two tiles of wj and r
constexpr int kGrads = 13;                   // dJp's 12 entries and dw

// The pixel's Jacobian rows (Jp is (B, N, 2, 6)) and weight.
__device__ __forceinline__ void load_pixel(const float* __restrict__ Jp,
                                           const float* __restrict__ w,
                                           size_t bn, float (&jx)[6],
                                           float (&jy)[6], float& wn) {
  const float* jp = Jp + bn * 12;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    jx[k] = jp[k];
    jy[k] = jp[6 + k];
  }
  wn = w[bn];
}

// g, r and j of one (pixel, channel) from its five samples and src, each
// rounded as the plain version rounds it: g = (f1 - f2) / 2 (a halving is
// exact), r = src - f0, and j_k = -(g_y Jp[1][k] + round(g_x Jp[0][k])) as
// one fused multiply-add, which is how cuBLAS forms a (C x 2) @ (2 x 6)
// product. The intrinsics keep nvcc from contracting anything else.
__device__ __forceinline__ void residual_jacobian(
    const float* __restrict__ fc, float s, int N, const float (&jx)[6],
    const float (&jy)[6], float& gx, float& gy, float& r, float (&j)[6]) {
  const float f0 = fc[0];
  const float f1 = fc[N];
  const float f2 = fc[2 * N];
  const float f3 = fc[3 * N];
  const float f4 = fc[4 * N];
  gx = __fmul_rn(__fsub_rn(f1, f2), 0.5f);
  gy = __fmul_rn(__fsub_rn(f3, f4), 0.5f);
  r = __fsub_rn(s, f0);
#pragma unroll
  for (int k = 0; k < 6; ++k) j[k] = -__fmaf_rn(gy, jy[k], __fmul_rn(gx, jx[k]));
}

// H's chunk partials. Element e = n C + c of a batch element's K = N C
// (pixel n, channel c) belongs to lane e mod 64 and to chunk e / 16384.
// Block (chunk, b), thread (lane, row k): the 6 sums over the lane's 256
// elements of the chunk, in ascending e, of w j_k j_l (one fused
// multiply-add each, from 0). Writes partial[b][chunk][lane][k][l].
// The block stages g of 2048 elements at a time in shared memory, read
// from f coalesced along N; a thread then reads g of its element there.
__global__ void __launch_bounds__(kLanes * 6)
normal_equations_chunk_kernel(const float* __restrict__ f,
                              const float* __restrict__ Jp,
                              const float* __restrict__ w,
                              float* __restrict__ partial, int C, int N) {
  __shared__ float gx_tile[kStage];
  __shared__ float gy_tile[kStage];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x;
  const int k = threadIdx.y;
  const int tid = k * kLanes + lane;
  const int start = chunk * kChunk;
  const int end = min(N * C, start + kChunk);
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float* fb = f + static_cast<size_t>(b) * C * 5 * N;
  for (int e0 = start; e0 < end; e0 += kSub) {
    const int e1 = min(end, e0 + kSub);
    const int n0 = e0 / C;
    const int pixels = (e1 - 1) / C - n0 + 1;
    // g of (pixel n, channel c) at (n - n0) (C + 1) + c: conflict-free
    // both along n (staging) and along c (reading)
    __syncthreads();
    for (int i = tid; i < C * pixels; i += kLanes * 6) {
      const int c = i / pixels;
      const int n = n0 + i % pixels;
      const int e = n * C + c;
      if (e < e0 || e >= e1) continue;
      const float* fc = fb + static_cast<size_t>(c) * 5 * N + n;
      const int at = (n - n0) * (C + 1) + c;
      gx_tile[at] = __fmul_rn(__fsub_rn(fc[N], fc[2 * N]), 0.5f);
      gy_tile[at] = __fmul_rn(__fsub_rn(fc[3 * N], fc[4 * N]), 0.5f);
    }
    __syncthreads();
    int n = (e0 + lane) / C;
    int c = (e0 + lane) % C;
    for (int e = e0 + lane; e < e1; e += kLanes) {
      const int at = (n - n0) * (C + 1) + c;
      const float gx = gx_tile[at];
      const float gy = gy_tile[at];
      float jx[6], jy[6], wn;
      load_pixel(Jp, w, static_cast<size_t>(b) * N + n, jx, jy, wn);
      float j[6];
#pragma unroll
      for (int l = 0; l < 6; ++l)
        j[l] = -__fmaf_rn(gy, jy[l], __fmul_rn(gx, jx[l]));
      const float wj = __fmul_rn(j[k], wn);
#pragma unroll
      for (int l = 0; l < 6; ++l) acc[l] = __fmaf_rn(wj, j[l], acc[l]);
      c += kLanes;
      while (c >= C) {
        c -= C;
        ++n;
      }
    }
  }
  float* out = partial + ((static_cast<size_t>(b) * gridDim.x + chunk) * kLanes +
                          lane) * 36 + k * 6;
#pragma unroll
  for (int l = 0; l < 6; ++l) out[l] = acc[l];
}

// H from the chunk partials. Block b, thread (half, entry): the running sum
// over the half's 32 lanes in order and, within a lane, over its chunks in
// order; then H = half 0 + half 1.
__global__ void normal_equations_fold_kernel(const float* __restrict__ partial,
                                             int chunks, float* __restrict__ H) {
  __shared__ float upper[36];
  const int b = blockIdx.x;
  const int half = threadIdx.x / 36;
  const int entry = threadIdx.x % 36;
  float sum = 0.f;
  for (int lane = half * kHalf; lane < (half + 1) * kHalf; ++lane) {
    const float* p = partial + (static_cast<size_t>(b) * chunks * kLanes + lane) *
                                   36 + entry;
    for (int chunk = 0; chunk < chunks; ++chunk)
      sum = __fadd_rn(sum, p[static_cast<size_t>(chunk) * kLanes * 36]);
  }
  if (half == 1) upper[entry] = sum;
  __syncthreads();
  if (half == 0) H[b * 36 + entry] = __fadd_rn(sum, upper[entry]);
}

// b. Element e' = c N + n of a batch element (channel-major, as the plain
// version's einsum lays it out) belongs to lane e' mod 32, which sums
// w j_k r over its elements in ascending e' (one fused multiply-add each,
// from 0); a shuffle tree (offsets 16, 8, 4, 2, 1) then adds the lanes and
// b_k is minus lane 0's sum. Block (k, b): all its threads form w j_k and
// r of a tile of 8192 consecutive elements in shared memory (coalesced
// along N; kBSmem bytes, two tiles), and warp 0 runs the 32 sums over it
// while the others form the next tile.
__global__ void __launch_bounds__(kBThreads)
normal_equations_b_kernel(const float* __restrict__ f,
                          const float* __restrict__ src,
                          const float* __restrict__ Jp,
                          const float* __restrict__ w,
                          float* __restrict__ bvec, int C, int N) {
  extern __shared__ float tiles[];     // wj of tiles 0, 1; r of tiles 0, 1
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int K = N * C;
  const int count = (K + kBTile - 1) / kBTile;
  const float* fb = f + static_cast<size_t>(b) * C * 5 * N;
  const float* sb = src + static_cast<size_t>(b) * C * N;
  float acc = 0.f;
  for (int t = 0; t < count; ++t) {
    float* wj_tile = tiles + (t & 1) * kBTile;
    float* r_tile = tiles + (2 + (t & 1)) * kBTile;
#pragma unroll
    for (int m = 0; m < kBTile / kBThreads; ++m) {
      const int i = tid + m * kBThreads;
      const int e = t * kBTile + i;
      float wj = 0.f, r = 0.f;
      if (e < K) {
        const int c = e / N;
        const int n = e % N;
        const size_t bn = static_cast<size_t>(b) * N + n;
        const float* jp = Jp + bn * 12;
        const float* fc = fb + static_cast<size_t>(c) * 5 * N + n;
        const float gx = __fmul_rn(__fsub_rn(fc[N], fc[2 * N]), 0.5f);
        const float gy = __fmul_rn(__fsub_rn(fc[3 * N], fc[4 * N]), 0.5f);
        const float j = -__fmaf_rn(gy, jp[6 + k], __fmul_rn(gx, jp[k]));
        wj = __fmul_rn(j, w[bn]);
        r = __fsub_rn(sb[static_cast<size_t>(c) * N + n], fc[0]);
      }
      wj_tile[i] = wj;
      r_tile[i] = r;
    }
    __syncthreads();
    if (tid < 32) {
#pragma unroll 8
      for (int i = tid; i < kBTile; i += 32)
        acc = __fmaf_rn(wj_tile[i], r_tile[i], acc);
    }
  }
  if (tid < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (tid == 0) bvec[b * 6 + k] = -acc;
  }
}

__global__ void __launch_bounds__(kThreads)
normal_equations_bwd_kernel(const float* __restrict__ f,
                            const float* __restrict__ src,
                            const float* __restrict__ Jp,
                            const float* __restrict__ w,
                            const float* __restrict__ dH,
                            const float* __restrict__ db,
                            float* __restrict__ df, float* __restrict__ dsrc,
                            float* __restrict__ dJp, float* __restrict__ dw,
                            int C, int N) {
  __shared__ float S[36];
  __shared__ float sdb[6];
  __shared__ float red[kGroups][kGrads][kPixels];
  const int b = blockIdx.y;
  const int tid = threadIdx.y * kPixels + threadIdx.x;
  if (tid < 36) {
    const int k = tid / 6, l = tid % 6;
    S[tid] = dH[b * 36 + k * 6 + l] + dH[b * 36 + l * 6 + k];
  } else if (tid < 42) {
    sdb[tid - 36] = db[b * 6 + tid - 36];
  }
  __syncthreads();
  const int n0 = blockIdx.x * kPixels;
  const int n = n0 + threadIdx.x;
  float acc[kGrads];
#pragma unroll
  for (int i = 0; i < kGrads; ++i) acc[i] = 0.f;
  if (n < N) {
    float jx[6], jy[6], wn;
    const size_t bn = static_cast<size_t>(b) * N + n;
    load_pixel(Jp, w, bn, jx, jy, wn);
    const size_t fbase = static_cast<size_t>(b) * C * 5 * N + n;
    const size_t sbase = static_cast<size_t>(b) * C * N + n;
#pragma unroll 2
    for (int c = threadIdx.y; c < C; c += kGroups) {
      const size_t fo = fbase + static_cast<size_t>(c) * 5 * N;
      const size_t so = sbase + static_cast<size_t>(c) * N;
      float gx, gy, r, j[6];
      residual_jacobian(f + fo, src[so], N, jx, jy, gx, gy, r, j);
      float jdb = 0.f, jSj = 0.f, Sj[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float s = 0.f;
#pragma unroll
        for (int l = 0; l < 6; ++l) s += S[k * 6 + l] * j[l];
        Sj[k] = s;
        jSj += j[k] * s;
        jdb += j[k] * sdb[k];
      }
      const float dr = -wn * jdb;
      float dgx = 0.f, dgy = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float dj = wn * (Sj[k] - r * sdb[k]);
        dgx -= jx[k] * dj;
        dgy -= jy[k] * dj;
        acc[k] -= gx * dj;
        acc[6 + k] -= gy * dj;
      }
      // j^T dH j = j^T S j / 2
      acc[12] += 0.5f * jSj - r * jdb;
      float* o = df + fo;
      o[0] = -dr;
      o[N] = 0.5f * dgx;
      o[2 * N] = -0.5f * dgx;
      o[3 * N] = 0.5f * dgy;
      o[4 * N] = -0.5f * dgy;
      dsrc[so] = dr;
    }
  }
  // a pixel's channel groups meet, in group order
#pragma unroll
  for (int i = 0; i < kGrads; ++i) red[threadIdx.y][i][threadIdx.x] = acc[i];
  __syncthreads();
  for (int e = tid; e < kGrads * kPixels; e += kThreads) {
    const int i = e / kPixels;
    const int p = e % kPixels;
    if (n0 + p >= N) continue;
    float sum = red[0][i][p];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) sum += red[g][i][p];
    const size_t bn = static_cast<size_t>(b) * N + n0 + p;
    if (i < 12)
      dJp[bn * 12 + i] = sum;
    else
      dw[bn] = sum;
  }
}

}  // namespace

extern "C" {

// Forward. f (B, C, 5, N), src (B, C, N), Jp (B, N, 2, 6), w (B, N): fp32,
// contiguous, on the device; partial: fp32 scratch of
// B x ceil(N C / 16384) x 64 x 36; H (B, 6, 6), b (B, 6) fp32. Launches on
// `stream` and returns cudaGetLastError().
int gauss_newton_normal_equations_f32(const float* f, const float* src,
                                      const float* Jp, const float* w,
                                      float* partial, float* H, float* b,
                                      int B, int C, int N, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int chunks = (N * C + kChunk - 1) / kChunk;
  normal_equations_chunk_kernel<<<dim3(chunks, B), dim3(kLanes, 6), 0,
                                  stream>>>(f, Jp, w, partial, C, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  normal_equations_fold_kernel<<<B, 72, 0, stream>>>(partial, chunks, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(normal_equations_b_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  normal_equations_b_kernel<<<dim3(6, B), kBThreads, kBSmem, stream>>>(
      f, src, Jp, w, b, C, N);
  return static_cast<int>(cudaGetLastError());
}

// Backward. As the forward, plus dH (B, 6, 6) and db (B, 6) in; df
// (B, C, 5, N), dsrc (B, C, N), dJp (B, N, 2, 6) and dw (B, N) out, each
// element written once.
int gauss_newton_normal_equations_bwd_f32(
    const float* f, const float* src, const float* Jp, const float* w,
    const float* dH, const float* db, float* df, float* dsrc, float* dJp,
    float* dw, int B, int C, int N, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (N + kPixels - 1) / kPixels;
  normal_equations_bwd_kernel<<<dim3(blocks, B), dim3(kPixels, kGroups), 0,
                                stream>>>(f, src, Jp, w, dH, db, df, dsrc,
                                          dJp, dw, C, N);
  return static_cast<int>(cudaGetLastError());
}

const char* gauss_newton_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
