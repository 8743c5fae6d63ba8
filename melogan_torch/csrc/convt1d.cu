// Transposed 1-D convolution, torch ConvTranspose1d geometry, channels last.
//
// Replaces: melogan_tpu/ops/pallas/conv1d.py::_convt_kernel (reached through
// _pallas_convt_fwd_impl / pallas_conv_transpose1d). That kernel computes the
// output as parity planes, out[s*t + r] = sum over _convt_taps of
// x[t + off] . w_flip[j], and interleaves them afterwards, because Mosaic has
// no strided stores. A GPU thread can write any address, so this kernel
// writes the interleaved output directly and needs no planar detour.
//
// Layout: x (B, L, Cin) f32, w HIO (K, Cin, Cout) f32 as stored by the JAX
// package (torch weight (Cin, Cout, K) permuted to (K, Cin, Cout)), optional
// bias (Cout,), y (B, Lout, Cout) with Lout = (L-1)*s - 2p + K + op.
//   y[b, t, co] = bias[co] + sum_{k : (t + p - k) = s*i, 0 <= i < L}
//                             sum_ci x[b, i, ci] * w[k, ci, co]
//
// Bound on an H100 SXM: the decoder's three layers do 2*5*L*Cin*Cout flops
// per sample on 4 bytes of output per Cout, about 436 flops per byte of
// x + y at Cin=256, so IEEE f32 FMA throughput (67 TFLOP/s outside the
// tensor cores) bounds it, not HBM (3.35 TB/s).
//
// Design: two kernels, picked per launch by shape.
// - Tiled (wide layers with enough work): a thread computes 8 outputs of one
//   parity class (t, t + s, ..., which share their taps and read
//   consecutive x rows) by 4 consecutive output channels. Lanes run over the
//   channel groups, so a warp reads one x value per row (a broadcast) and 32
//   consecutive float4 weights (coalesced); each weight float4 is reused 8
//   times and each x value 4 times from registers. Taken where Cout >= 64
//   and the grid still gives the card 4 waves of 256-thread blocks.
// - Simple (narrow layers, small batches): one thread per output element
//   (b, t, co), co fastest, so neighbouring lanes share x reads and read
//   consecutive weights. It spreads a small batch over more SMs, and for 4
//   output channels it keeps a warp on 8 neighbouring rows of x.
// Both accumulate with fmaf in IEEE f32 and keep nothing in shared memory;
// a tiled implicit-GEMM design is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTT = 8;               // outputs of one parity class per tiled thread
constexpr int kMinBlocks = 4 * 132;  // 4 waves on an H100's 132 SMs

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__global__ void convt1d_simple(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               float* __restrict__ y, int L, int Cin, int Cout,
                               int K, int stride, int padding, int Lout,
                               long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = (int)(idx % Cout);
  const long long row = idx / Cout;
  const int t = (int)(row % Lout);
  const long long b = row / Lout;

  float acc = bias != nullptr ? bias[co] : 0.0f;
  const float* xb = x + b * (long long)L * Cin;
  for (int k = 0; k < K; ++k) {
    const int num = t + padding - k;
    if (num < 0 || num % stride != 0) continue;
    const int i = num / stride;
    if (i >= L) continue;
    const float* xr = xb + (long long)i * Cin;
    const float* wk = w + (long long)k * Cin * Cout + co;
#pragma unroll 4
    for (int ci = 0; ci < Cin; ++ci) {
      acc = fmaf(xr[ci], wk[(long long)ci * Cout], acc);
    }
  }
  y[idx] = acc;
}

// Tiled kernel; kVec: Cout % 4 == 0 and w 16-byte aligned (float4 weights).
template <bool kVec>
__global__ void convt1d_tiled(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               float* __restrict__ y, int L, int Cin, int Cout,
                               int K, int stride, int padding, int Lout,
                               int ncg, int njb, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = (int)(idx % ncg) * 4;
  long long rest = idx / ncg;
  const int jb = (int)(rest % njb);
  rest /= njb;
  const int r = (int)(rest % stride);
  const long long b = rest / stride;
  const int t0 = r + stride * jb * kTT;  // outputs t0 + stride * u
  if (t0 >= Lout) return;

  float acc[kTT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float bj = (bias != nullptr && co + j < Cout) ? bias[co + j] : 0.f;
#pragma unroll
    for (int u = 0; u < kTT; ++u) acc[u][j] = bj;
  }
  const float* xb = x + b * (long long)L * Cin;
  for (int k = 0; k < K; ++k) {
    const int num = t0 + padding - k;
    if (((num % stride) + stride) % stride != 0) continue;
    const int i0 = floor_div(num, stride);  // x row of output t0; +u for t0 + s*u
    if (i0 >= L || i0 + kTT <= 0) continue;
    const float* wk = w + (long long)k * Cin * Cout + co;
    for (int ci = 0; ci < Cin; ++ci) {
      float wv[4];
      if (kVec) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(wk + (long long)ci * Cout));
        wv[0] = q.x; wv[1] = q.y; wv[2] = q.z; wv[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wv[j] = co + j < Cout ? __ldg(wk + (long long)ci * Cout + j) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kTT; ++u) {
        const int i = i0 + u;
        const float xv = (i >= 0 && i < L) ? __ldg(xb + (long long)i * Cin + ci) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[u][j] = fmaf(xv, wv[j], acc[u][j]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kTT; ++u) {
    const int t = t0 + stride * u;
    if (t >= Lout) break;
    float* yr = y + (b * Lout + t) * (long long)Cout + co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (co + j < Cout) yr[j] = acc[u][j];
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int; the Python wrapper raises if it is not 0.
extern "C" int melogan_convt1d(const float* x, const float* w,
                               const float* bias, float* y, int B, int L,
                               int Cin, int Cout, int K, int stride,
                               int padding, int Lout, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long outputs = (long long)B * Lout * Cout;
  if (outputs == 0) return 0;
  const int ncg = (Cout + 3) / 4;
  const int njb = ((Lout + stride - 1) / stride + kTT - 1) / kTT;
  const long long tiles = (long long)B * stride * njb * ncg;
  const long long tiled_blocks = (tiles + kThreads - 1) / kThreads;
  if (Cout >= 64 && tiled_blocks >= kMinBlocks) {
    if (Cout % 4 == 0 && ((unsigned long long)w & 15) == 0) {
      convt1d_tiled<true><<<(unsigned int)tiled_blocks, kThreads, 0, s>>>(
          x, w, bias, y, L, Cin, Cout, K, stride, padding, Lout, ncg, njb, tiles);
    } else {
      convt1d_tiled<false><<<(unsigned int)tiled_blocks, kThreads, 0, s>>>(
          x, w, bias, y, L, Cin, Cout, K, stride, padding, Lout, ncg, njb, tiles);
    }
  } else {
    const long long blocks = (outputs + kThreads - 1) / kThreads;
    convt1d_simple<<<(unsigned int)blocks, kThreads, 0, s>>>(
        x, w, bias, y, L, Cin, Cout, K, stride, padding, Lout, outputs);
  }
  return (int)cudaGetLastError();
}
