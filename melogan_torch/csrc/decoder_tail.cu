// Fused generator-decoder tail: three k5/s2/p2/op1 transposed convolutions
// (bias, ReLU after the first two) in one kernel, channels last.
//
// Replaces: melogan_tpu/ops/pallas/decoder.py::_decoder_kernel (reached
// through fused_decoder_tail). The TPU kernel keeps the chain in VMEM as
// parity planes (1 -> 2 -> 4 -> 8 planes of length M) because Mosaic has no
// strided slices, and interleaves once at the end. Here each stage writes its
// interleaved output straight into shared memory, so no planes and no final
// interleave are needed.
//
// Shapes on the main path: x (B, M=64, C0=256) -> (B, 128, 128) -> (B, 256, 64)
// -> y (B, 512, C3=4), f32. Weights HIO (5, Cin, Cout) with eval BatchNorm
// folded in ahead of the kernel, biases (Cout,).
//
// Bound on an H100 SXM: 2*(5L-3)*Cin*Cout summed over the stages (the valid
// taps) = 31.9 MFLOP per sample on 73.7 KB of x and y, about 430 flops per
// byte: IEEE f32 FMA throughput (67 TFLOP/s outside the tensor cores)
// bounds it, not HBM (3.35 TB/s).
//
// Design: one CTA of 512 threads per sample. x is copied into shared
// buffer A; stage 1 writes buffer B (2M x C1); stage 2 writes back into A,
// whose input is dead by then (4M x C2); stage 3 writes y to global memory.
// Only x is read from and only y written to device memory, which is what
// the Pallas kernel keeps out of HBM. Each buffer carries one zero row above
// and below, so the boundary taps (rows m-1, m+1) read zeros without a
// branch, and rows are padded to an odd number of floats (C + 1).
//
// Each warp takes 64 rows by TCO (8, or 4 for the 4-channel last stage)
// output channels; lane l owns rows l and l + 32, so the 32 lanes read 32
// consecutive rows of the odd stride, which fall in 32 different banks. The
// weights of one chunk of input channels (5 taps x CK x Cout, 40 KB where
// shared memory allows, else 20 KB) are staged in shared
// memory with cp.async, double-buffered so the next chunk loads while this
// one is used; a warp's lanes all read the same weights (a broadcast). Per
// input channel a lane loads 6 activations and 10 float4 weights for 80
// FMAs. At the main-path widths the peak is (66*257 + 130*129 + 2*10240)
// floats = 212 KB of dynamic shared memory: one CTA (16 warps) per SM.
// Accumulation is fmaf in IEEE f32. A tensor-core redesign is later work.
//
// Tap algebra for k5/s2/p2 (torch geometry, unflipped HIO weights w[k]):
//   y[2m]   = x[m+1] w[0] + x[m] w[2] + x[m-1] w[4]
//   y[2m+1] = x[m+1] w[1] + x[m] w[3]
// which is _taps(r) of decoder.py with w_flip[j] = w[4-j].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 2;              // rows per lane, 32 rows apart

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage weights w[k][ci0 : ci0 + n][:] of the 5 taps into dst[k][0 : n][:]
// (tap stride ck * Cout floats). Cout % 4 == 0, so rows are whole float4s.
__device__ __forceinline__ void load_chunk(const float* __restrict__ w, int Cin,
                                           int Cout, int ci0, int n, int ck,
                                           float* dst) {
  const int per_tap = (n * Cout) >> 2;
  for (int idx = threadIdx.x; idx < 5 * per_tap; idx += blockDim.x) {
    const int k = idx / per_tap;
    const int j = (idx - k * per_tap) << 2;
    cp_async16(dst + k * ck * Cout + j, w + ((long long)k * Cin + ci0) * Cout + j);
  }
  cp_async_commit();
}

// One stride-2 transposed-conv stage.
// in:  shared, (Lin + 2) rows of `istride` floats; row q holds logical row
//      q - 1, rows 0 and Lin + 1 are zero.
// out: shared with the same margin convention ((2 Lin + 2) rows of
//      `ostride` floats) when !kGlobalOut, else global (2 Lin rows of Cout).
// wbuf: shared, 2 x kWBuf floats, 16-byte aligned; kWBuf >= 5 * Cout.
// Every thread of the CTA calls this (it synchronises inside).
template <int TCO, int kWBuf, bool kRelu, bool kGlobalOut>
__device__ void stage(const float* in, int istride, int Lin, int Cin,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, int Cout, float* wbuf,
                      float* out, int ostride) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ncg = Cout / TCO;
  const int ntiles = ((Lin + 32 * kTM - 1) / (32 * kTM)) * ncg;
  const int ck = min(Cin, kWBuf / (5 * Cout));
  const int nch = (Cin + ck - 1) / ck;
  for (int t0 = 0; t0 < ntiles; t0 += kWarps) {
    const int tile = t0 + warp;
    const bool active = tile < ntiles;  // warp-uniform
    const int co = active ? (tile % ncg) * TCO : 0;
    const int r0 = active ? (tile / ncg) * 32 * kTM + lane : 0;
    bool ok[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) ok[i] = active && r0 + 32 * i < Lin;
    float ev[kTM][TCO], od[kTM][TCO];
#pragma unroll
    for (int j = 0; j < TCO; ++j) {
      const float bj = active ? __ldg(bias + co + j) : 0.f;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        ev[i][j] = bj;
        od[i][j] = bj;
      }
    }

    load_chunk(w, Cin, Cout, 0, min(ck, Cin), ck, wbuf);
    for (int c = 0; c < nch; ++c) {
      const int ci0 = c * ck;
      const int n = min(ck, Cin - ci0);
      if (c + 1 < nch) {
        load_chunk(w, Cin, Cout, ci0 + ck, min(ck, Cin - ci0 - ck), ck,
                   wbuf + ((c + 1) & 1) * kWBuf);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* wc = wbuf + (c & 1) * kWBuf + co;
      if (active) {
        for (int cc = 0; cc < n; ++cc) {
          // x[r-1], x[r], x[r+1] of each owned row r (margined rows r..r+2)
          float xm[kTM], x0[kTM], xp[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float* q = in + (r0 + 32 * i) * istride + ci0 + cc;
            xm[i] = ok[i] ? q[0] : 0.f;
            x0[i] = ok[i] ? q[istride] : 0.f;
            xp[i] = ok[i] ? q[2 * istride] : 0.f;
          }
          // y[2r] = x[r+1] w0 + x[r] w2 + x[r-1] w4; y[2r+1] = x[r+1] w1 + x[r] w3
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            const float4* wq = reinterpret_cast<const float4*>(wc + (k * ck + cc) * Cout);
#pragma unroll
            for (int j4 = 0; j4 < TCO / 4; ++j4) {
              const float4 wv = wq[j4];
              const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int j = 4 * j4 + jj;
#pragma unroll
                for (int i = 0; i < kTM; ++i) {
                  if (k == 0) ev[i][j] = fmaf(xp[i], wj[jj], ev[i][j]);
                  if (k == 1) od[i][j] = fmaf(xp[i], wj[jj], od[i][j]);
                  if (k == 2) ev[i][j] = fmaf(x0[i], wj[jj], ev[i][j]);
                  if (k == 3) od[i][j] = fmaf(x0[i], wj[jj], od[i][j]);
                  if (k == 4) ev[i][j] = fmaf(xm[i], wj[jj], ev[i][j]);
                }
              }
            }
          }
        }
      }
      __syncthreads();  // this buffer is refilled two chunks on
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (!ok[i]) continue;
      const int r = r0 + 32 * i;
      float* e = kGlobalOut ? out + (long long)(2 * r) * Cout + co
                            : out + (2 * r + 1) * ostride + co;
      float* o = kGlobalOut ? e + Cout : e + ostride;
#pragma unroll
      for (int j = 0; j < TCO; ++j) {
        e[j] = kRelu ? fmaxf(ev[i][j], 0.f) : ev[i][j];
        o[j] = kRelu ? fmaxf(od[i][j], 0.f) : od[i][j];
      }
    }
  }
}

// An 8-channel tile where Cout allows, else 4 (Cout % 4 == 0): at the
// main-path widths that is 16 warps' worth of tiles in stages 1 and 2.
template <int kWBuf, bool kRelu, bool kGlobalOut>
__device__ void stage_any(const float* in, int istride, int Lin, int Cin,
                          const float* __restrict__ w,
                          const float* __restrict__ bias, int Cout, float* wbuf,
                          float* out, int ostride) {
  if (Cout % 8 == 0) {
    stage<8, kWBuf, kRelu, kGlobalOut>(in, istride, Lin, Cin, w, bias, Cout, wbuf, out, ostride);
  } else {
    stage<4, kWBuf, kRelu, kGlobalOut>(in, istride, Lin, Cin, w, bias, Cout, wbuf, out, ostride);
  }
}

// Zero row 0 and row `rows + 1` of a margined buffer of `stride`-float rows.
__device__ __forceinline__ void zero_margins(float* buf, int rows, int stride) {
  for (int c = threadIdx.x; c < stride; c += blockDim.x) {
    buf[c] = 0.f;
    buf[(rows + 1) * stride + c] = 0.f;
  }
}

// Floats of shared buffer A: x (M + 2 rows of C0 + 1), later stage 2's
// output (4M + 2 rows of C2 + 1).
__host__ __device__ inline int a_floats(int M, int C0, int C2) {
  const int in = (M + 2) * (C0 + 1);
  const int mid = (4 * M + 2) * (C2 + 1);
  return in > mid ? in : mid;
}

// kWBuf: floats of one weight-chunk buffer (10240 or 5120, see wbuf_for).
template <int kWBuf>
__global__ void __launch_bounds__(kThreads)
decoder_tail_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ w3,
                    const float* __restrict__ b3, float* __restrict__ y, int M,
                    int C0, int C1, int C2, int C3) {
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // 2 weight chunks, aligned
  float* A = W + 2 * kWBuf;
  float* Bf = A + a_floats(M, C0, C2);
  const long long b = blockIdx.x;

  // x[b] -> A rows 1..M, row stride C0 + 1 (coalesced reads, no conflicts)
  const float* xb = x + b * M * C0;
  for (int i = threadIdx.x; i < M * C0; i += blockDim.x) {
    const int m = i / C0;
    A[(m + 1) * (C0 + 1) + (i - m * C0)] = __ldg(xb + i);
  }
  zero_margins(A, M, C0 + 1);
  zero_margins(Bf, 2 * M, C1 + 1);
  __syncthreads();

  stage_any<kWBuf, true, false>(A, C0 + 1, M, C0, w1, b1, C1, W, Bf, C1 + 1);
  __syncthreads();

  // A's input is dead: re-margin it for the (4M, C2 + 1) layout and refill it
  zero_margins(A, 4 * M, C2 + 1);
  stage_any<kWBuf, true, false>(Bf, C1 + 1, 2 * M, C1, w2, b2, C2, W, A, C2 + 1);
  __syncthreads();

  stage_any<kWBuf, false, true>(A, C2 + 1, 4 * M, C2, w3, b3, C3, W,
                                y + b * 8 * M * C3, C3);
}

}  // namespace

// Floats of one weight-chunk buffer: 10240 (40 KB) where the card's shared
// memory per block (`limit` bytes) takes two of them beside the
// activations, else 5120; 0 if neither fits or a chunk would not hold one
// input channel (5 * Cout floats).
static int wbuf_for(int M, int C0, int C1, int C2, int C3, int limit) {
  const long long act = (long long)a_floats(M, C0, C2) + (long long)(2 * M + 2) * (C1 + 1);
  const int cmax = C1 > C2 ? (C1 > C3 ? C1 : C3) : (C2 > C3 ? C2 : C3);
  for (int wf : {10240, 5120}) {
    if (wf >= 5 * cmax && (act + 2LL * wf) * (long long)sizeof(float) <= limit) return wf;
  }
  return 0;
}

// Dynamic shared memory of one CTA in bytes for the given widths on a card
// allowing `limit` bytes per block, or -1 if they do not fit.
extern "C" int melogan_decoder_tail_smem_bytes(int M, int C0, int C1, int C2,
                                               int C3, int limit) {
  const int wf = wbuf_for(M, C0, C1, C2, C3, limit);
  if (wf == 0) return -1;
  const long long act = (long long)a_floats(M, C0, C2) + (long long)(2 * M + 2) * (C1 + 1);
  return (int)((act + 2LL * wf) * (long long)sizeof(float));
}

template <int kWBuf>
static cudaError_t launch(const float* x, const float* w1, const float* b1,
                          const float* w2, const float* b2, const float* w3,
                          const float* b3, float* y, int B, int M, int C0,
                          int C1, int C2, int C3, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_kernel<kWBuf>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decoder_tail_kernel<kWBuf><<<B, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, w3, b3, y, M, C0, C1, C2, C3);
  return cudaGetLastError();
}

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() (or the error of the shared-memory attribute call) as
// an int; the Python wrapper raises if it is not 0.
extern "C" int melogan_decoder_tail(const float* x, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, const float* w3,
                                    const float* b3, float* y, int B, int M,
                                    int C0, int C1, int C2, int C3, int limit,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  const int smem = melogan_decoder_tail_smem_bytes(M, C0, C1, C2, C3, limit);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  err = wbuf_for(M, C0, C1, C2, C3, limit) == 10240
            ? launch<10240>(x, w1, b1, w2, b2, w3, b3, y, B, M, C0, C1, C2, C3, smem, s)
            : launch<5120>(x, w1, b1, w2, b2, w3, b3, y, B, M, C0, C1, C2, C3, smem, s);
  return (int)err;
}
