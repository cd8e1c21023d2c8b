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
// it. That mask is symmetric (-100 between tokens of different regions), so
// the kernel reads mask[m][j][i] for query i and key j: lanes of consecutive
// queries then read consecutive addresses. The output (nW, N, C) is the layout
// the output projection takes.
//
// What bounds it on an H100 at stage 0 of Swin-L at 192x640, batch 12
// (nW=672, 6 heads, N=144): about 11 GFLOP (q k^T and p v, 2 x 2 N^2 d per
// window and head), 0.17 ms on the 67 TFLOP/s fp32 pipes, against about
// 0.3 GB of traffic (qkv read once, out written once), 0.09 ms at 3.35 TB/s.
// So it is bound by operations.
//
// Design (a first, simple kernel): one block per (window, head), one thread
// per query row. K and V of the window and head sit in shared memory (2 x N
// x 32 x 4 B = 36.9 KB at N=144) and every thread reads the same key row at
// once, a broadcast; q stays in 32 registers, pre-scaled. Each thread runs
// an online softmax over the N keys (running max, running sum, 32-wide
// accumulator rescaled when the max grows), so no score leaves registers.
// The Pallas kernel's head chunking (a VMEM planner) is not carried over.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kD = 32;  // head width

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

}  // namespace

extern "C" {

// qkv: (nW, N, 3 * heads * 32) fp32, 16-byte aligned; table: ((2ws-1)^2,
// heads); mask: (nm, N, N) symmetric shift mask, or null; out: (nW, N,
// heads * 32). ws <= 16. All on the device. Launches on `stream`
// and returns cudaGetLastError().
int window_attention_f32(const float* qkv, const float* table,
                         const float* mask, float* out, int nW, int heads,
                         int ws, int nm, void* stream) {
  const int N = ws * ws;
  const int span = 2 * ws - 1;
  const size_t smem = 2 * static_cast<size_t>(N) * kD * sizeof(float) +
                      static_cast<size_t>(span) * span * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nW, heads);
  const dim3 block((N + 31) / 32 * 32);
  window_attention_kernel<<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      qkv, table, mask, out, heads, ws, nm,
      static_cast<float>(1.0 / sqrt(static_cast<double>(kD))));
  return static_cast<int>(cudaGetLastError());
}

const char* window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
