// Strided 1-D convolution, torch Conv1d geometry, channels last.
//
// Replaces: melogan_tpu/ops/pallas/conv1d.py::_conv1d_kernel (reached through
// _pallas_conv1d_fwd_impl / pallas_conv1d). That kernel splits the padded
// input into `stride` parity streams outside the kernel, because Mosaic has no
// strided loads, and then runs one contiguous-slice matmul per tap. A GPU
// thread can index x_pad[s*t + k] itself, so this kernel reads the input rows
// it needs straight from the (B, L, Cin) tensor and needs no streams.
//
// Layout: x (B, L, Cin) f32, w HIO (K, Cin, Cout) f32 (torch Conv1d weight
// (Cout, Cin, K) permuted to (K, Cin, Cout)), optional bias (Cout,),
// y (B, Lout, Cout) with Lout = (L + 2p - K) / s + 1.
//   y[b, t, co] = bias[co] + sum_k sum_ci x[b, s*t + k - p, ci] * w[k, ci, co]
// (rows outside [0, L) are the zero padding).
//
// Bound on an H100 SXM: the emotion discriminator's layers do 2*K*Cin*Cout
// flops per output row for 4*(Cin + Cout) bytes of x and y, 250-760 flops
// per byte at Cin >= 64, so IEEE f32 FMA throughput (67 TFLOP/s outside the
// tensor cores) bounds it, not HBM (3.35 TB/s). The ED forward at batch 32 is
// 10.5 GFLOP: 0.157 ms at that peak.
//
// Design, for that bound: a CTA of 128 threads computes a tile of 64 output
// rows x 64 output channels of one sample. Each thread keeps 4 rows x 8
// channels (32 sums) in registers, so every shared-memory read feeds 8 (x) or
// 4 (w) FMAs. Input channels go in chunks of 16: the input rows the tile needs
// ((64 - 1)*s + K of them) and the weight chunk (K x 16 x 64) are staged in
// shared memory with cp.async, two stages deep, so the next chunk loads while
// this one is used. Rows and channels outside the tensors are zero-filled by
// the copy itself (a zero source size). The x rows have an odd stride (17
// floats), so the 4 row groups of a warp hit different banks; the weights are
// read as float4, the same address across the row groups (a broadcast). A
// short chunk (Cin = 4, the notes) loops over its real channels only. All
// sums are IEEE f32 fmaf: no TF32, as the JAX package's Precision.HIGHEST.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;                  // output rows per thread
constexpr int kCh = 8;                    // output channels per thread
constexpr int kTx = 8;                    // channel groups per CTA
constexpr int kTy = kThreads / kTx;       // 16 row groups per CTA
constexpr int kTileT = kTy * kRows;       // 64 output rows per CTA
constexpr int kTileC = kTx * kCh;         // 64 output channels per CTA
constexpr int kChunk = 16;                // input channels per stage
constexpr int kXStride = kChunk + 1;      // odd row stride of the staged x
constexpr int kMaxK = 7;
constexpr int kMaxStride = 16;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // 0 source bytes: the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ int x_rows(int K, int stride) {
  return (kTileT - 1) * stride + K;
}

// floats of one stage: staged x rows (rounded to a float4 boundary), then w
__host__ __device__ __forceinline__ int xs_floats(int K, int stride) {
  return (x_rows(K, stride) * kXStride + 3) & ~3;
}

__host__ __device__ __forceinline__ int stage_floats(int K, int stride) {
  return xs_floats(K, stride) + K * kChunk * kTileC;
}

// Start the cp.async copies of input-channel chunk [c0, c0 + cc) into one stage.
__device__ __forceinline__ void stage_chunk(float* xs, float* ws, const float* x,
                                            const float* w, long long xoff, int in0,
                                            int rows, int L, int Cin, int Cout, int K,
                                            int co0, int c0, int cc) {
  for (int e = threadIdx.x; e < rows * kChunk; e += kThreads) {
    const int r = e / kChunk;
    const int ci = e - r * kChunk;
    const int i = in0 + r;
    const bool ok = ci < cc && i >= 0 && i < L;
    cp_async4(xs + r * kXStride + ci, ok ? x + xoff + (long long)i * Cin + c0 + ci : x, ok);
  }
  for (int e = threadIdx.x; e < K * kChunk * kTileC; e += kThreads) {
    const int co = e % kTileC;
    const int kc = e / kTileC;  // k * kChunk + ci
    const int k = kc / kChunk;
    const int ci = kc - k * kChunk;
    const bool ok = ci < cc && co0 + co < Cout;
    cp_async4(ws + e, ok ? w + ((long long)k * Cin + c0 + ci) * Cout + co0 + co : w, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
conv1d_tiled(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ y, int L, int Cin,
             int Cout, int K, int stride, int padding, int Lout, int row_tiles,
             int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x - b * row_tiles) * kTileT;
  const int co0 = blockIdx.y * kTileC;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int rows = x_rows(K, stride);
  const int xs_n = xs_floats(K, stride);
  const int st_n = stage_floats(K, stride);
  const long long xoff = (long long)b * L * Cin;
  const int in0 = stride * t0 - padding;  // input row of staged row 0

  float acc[kRows][kCh];
#pragma unroll
  for (int q = 0; q < kCh; ++q) {
    const int co = co0 + tx * kCh + q;
    const float bq = (bias != nullptr && co < Cout) ? bias[co] : 0.f;
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j][q] = bq;
  }

  const int nchunks = (Cin + kChunk - 1) / kChunk;
  stage_chunk(smem, smem + xs_n, x, w, xoff, in0, rows, L, Cin, Cout, K, co0, 0,
              Cin < kChunk ? Cin : kChunk);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      float* nxt = smem + ((c + 1) & 1) * st_n;
      const int c1 = (c + 1) * kChunk;
      stage_chunk(nxt, nxt + xs_n, x, w, xoff, in0, rows, L, Cin, Cout, K, co0, c1,
                  Cin - c1 < kChunk ? Cin - c1 : kChunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + (c & 1) * st_n;
    const float* ws = xs + xs_n;
    const int cc = Cin - c * kChunk < kChunk ? Cin - c * kChunk : kChunk;
    for (int k = 0; k < K; ++k) {
      // output row t0 + ty + kTy*j reads staged row s*(ty + kTy*j) + k
      const float* xk = xs + (stride * ty + k) * kXStride;
      const int jstep = stride * kTy * kXStride;
      const float* wk = ws + k * kChunk * kTileC + tx * kCh;
#pragma unroll 4
      for (int ci = 0; ci < cc; ++ci) {
        const float4 w0 = *reinterpret_cast<const float4*>(wk + ci * kTileC);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + ci * kTileC + 4);
        const float wv[kCh] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float xv = xk[j * jstep + ci];
#pragma unroll
          for (int q = 0; q < kCh; ++q) acc[j][q] = fmaf(xv, wv[q], acc[j][q]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  const int co = co0 + tx * kCh;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int t = t0 + ty + kTy * j;
    if (t >= Lout) continue;
    float* yr = y + ((long long)b * Lout + t) * Cout + co;
    if (vec_out && co + kCh <= Cout) {
      reinterpret_cast<float4*>(yr)[0] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      reinterpret_cast<float4*>(yr)[1] = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
    } else {
#pragma unroll
      for (int q = 0; q < kCh; ++q) {
        if (co + q < Cout) yr[q] = acc[j][q];
      }
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int; the Python wrapper raises if it is not 0.
extern "C" int melogan_conv1d(const float* x, const float* w, const float* bias,
                              float* y, int B, int L, int Cin, int Cout, int K,
                              int stride, int padding, int Lout, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kMaxK || stride < 1 || stride > kMaxStride || Cin < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * Lout * Cout == 0) return 0;
  // two stages; at K = 7 and stride 16 this is 195 KB
  const int smem = 2 * stage_floats(K, stride) * (int)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(conv1d_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int row_tiles = (Lout + kTileT - 1) / kTileT;
  const long long gx = (long long)B * row_tiles;
  const int gy = (Cout + kTileC - 1) / kTileC;
  if (gx >= (1LL << 31) || gy > 65535) return (int)cudaErrorInvalidValue;
  const int vec_out = (Cout % 4 == 0 && ((unsigned long long)y & 15) == 0) ? 1 : 0;
  conv1d_tiled<<<dim3((unsigned int)gx, (unsigned int)gy), kThreads, smem,
                 (cudaStream_t)stream>>>(x, w, bias, y, L, Cin, Cout, K, stride, padding,
                                         Lout, row_tiles, vec_out);
  return (int)cudaGetLastError();
}
