// Implicit-GEMM core of the decoder tail (decoder_tail.cu): tensor cores in
// 3xTF32 by mma.sync, operands staged by cp.async in three stages. The convs
// have cores of their own: igemm_tf32x3.cuh (their f32 mode: TMA, wgmma,
// persistent CTAs) and igemm_bf16.cuh (their one-pass bf16 mode).
//
// Replaces, through decoder_tail.cu:
//   melogan_tpu/ops/pallas/decoder.py::_decoder_kernel (three transposed
//     convs, bias and ReLU after the first two: three launches)
//
// What it computes: one generalised conv over channels-last rows,
//   Y[b, t, n] = bias[n mod Cout]
//              + sum_{q < Q} sum_ci X[b, sigma*t + o_min + q, ci] * W'[q, ci, n]
// (rows outside [0, L) are zero). Column n is tap class r = n div Cout and
// output channel co = n mod Cout; row t of class r is output row
// classes*t + r, stored only where that is below Lout.
// - conv1d: sigma = stride, o_min = -padding, Q = K, one class, W'[q] = w[q].
// - transposed conv: sigma = 1, one class per output parity. W'[q, :, n] is
//   w[taps[r][q], :, co], or a structural zero where taps[r][q] = -1.
// The geometry (the tap table, the tile and the shared-memory layout) is
// computed on the host by melogan_torch/ops/igemm.py and arrives as a Plan
// by value. w is read in place through the table; nothing builds W'.
//
// Bound on an H100 SXM: at the decoder's and the emotion discriminator's
// widths the convs do 100-800 flops per byte of x, w and y, so operations
// bound them. Parity is f32 (TF32 off), so the sums run in 3xTF32: each
// operand a is split into big = tf32_rna(a) and small = tf32_rna(a - big),
// and small*big + big*small + big*big are summed in f32. That is
// f32-accurate (the card's counterpart of the TPU's multi-pass
// Precision.HIGHEST), at up to 495/3 = 165 TFLOP/s of f32 work against
// 67 TFLOP/s of IEEE f32 FMAs outside the tensor cores.
//
// Design:
// - mma.sync.m16n8k8 tf32, three per product step. A CTA of 4 or 8 warps
//   takes a TM (rows t of one sample) x TN (columns n) tile; each warp holds
//   32 x (8*kWN) sums. Narrow N (Cout = 4, a transposed conv's 4-channel
//   layer, or an input gradient to 4 channels) takes an N tile of 8, 16 or 32.
// - The reduction runs over (q, ci) flattened, chunk by chunk of cw input
//   channels: a chunk's depth is (offsets this N tile uses) * cw, rounded up
//   to 8, so Cin = 4 with K = 5 costs 24 deep, not 5 * 8. An N tile inside
//   one class skips the offsets its class never uses.
// - For each chunk, the (TM - 1)*sigma + Q input rows the tile needs are
//   staged once and every offset q reads them as a view shifted by q rows
//   (the halo of an implicit GEMM), so x leaves HBM once per chunk, not once
//   per tap. The weight chunk (depth x TN) is staged beside it. 16-byte
//   cp.async.cg where channels and pointers allow, 4-byte cp.async.ca
//   otherwise; rows off the tensor are zero-filled by a zero source size.
// - A thread's two reduction indices of a k-step are adjacent channels, so
//   its A values of a row come in one 8-byte load. Row strides: x rows are
//   8, 24, 24 or 40 floats for cw = 4, 8, 16, 32 (8 or 24 mod 32) and w rows
//   TN + 4, so at sigma = 1 the fragment loads do not conflict on banks
//   (x at cw = 4 and at sigma = 2 conflicts 2-way).
// - One __syncthreads per chunk: the wait for chunk c is followed by the
//   copies of chunk c + 2 into the stage that chunk c - 1 used. The
//   fragments of the next pair of k-steps load while this pair multiplies.
// - Accuracy: the tensor cores add with truncation, so the products of each
//   pair of k-steps are summed from zero and folded into the f32 sum by
//   IEEE adds.
// - The store works out each column's class and channel once per thread and
//   writes 8-byte pairs of channels where Cout is even. With `relu` set it
//   clamps each sum at zero after the bias (the decoder tail's stages).
// Later work: the decoder tail on the core of igemm_tf32x3.cuh (ROADMAP B.8).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm {

constexpr int kMaxClasses = 16;
constexpr int kMaxQ = 8;
constexpr int kMaxK = 7;
constexpr int kMaxStride = 16;
constexpr int kStages = 3;
constexpr int kMaxSmem = 227 * 1024;

// Field for field the ctypes structure ops/igemm.py::CPlan.
struct Plan {
  int batch, l, cin, cout, k, stride;
  int n, classes, rows, lout;  // GEMM columns, tap classes, rows per sample, output rows
  int sigma, o_min, q;         // input row of (t, q) is sigma*t + o_min + q
  int cw, cw_shift;            // input channels per chunk, log2(cw)
  int tile_m, tile_n;
  int x_rows, x_stride, w_rows, w_stride, stage_floats, smem_bytes;
  signed char taps[kMaxClasses][kMaxQ];  // w tap of (class, offset), or -1
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 on finite values: add half of the 13 dropped mantissa
// bits to the magnitude, then clear them (ties away from zero). Two integer
// instructions; nvcc lowers the cvt to four, with a guard for inf and NaN
// that finite activations and weights do not need.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = big + small to about 2^-22 relative: both halves are tf32 values.
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
}

// d += A (16x8, row) * B (8x8, col), tf32 inputs, f32 sums. Fragments, with
// g = lane / 4 and i = lane % 4: a0 (g, i), a1 (g+8, i), a2 (g, i+4),
// a3 (g+8, i+4); b0 (row i, col g), b1 (row i+4, col g); d0 (g, 2i),
// d1 (g, 2i+1), d2 (g+8, 2i), d3 (g+8, 2i+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(  // not volatile: independent products may be reordered
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A * B, the same product with a zero sum to add to.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// CTA: kWarpsM x kWarpsN warps; a warp takes 32 rows (two m16 tiles) by
// TN / kWarpsN columns (kWN n8 tiles).
template <int TN, int kWarpsM, int kWarpsN>
__global__ void __launch_bounds__(32 * kWarpsM * kWarpsN)
igemm_conv(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ y,
           const __grid_constant__ Plan p, int vec_x, int vec_w, int relu) {
  constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  constexpr int kWM = 2;
  constexpr int kWN = TN / 8 / kWarpsN;
  constexpr int TM = 32 * kWarpsM;
  static_assert(kWN >= 1 && kWN * 8 * kWarpsN == TN, "N tile");
  static_assert(kThreads >= kMaxClasses * kMaxQ, "tap table copy");

  extern __shared__ __align__(16) float smem[];
  __shared__ signed char s_tap[kMaxClasses * kMaxQ];
  __shared__ int s_act[kMaxQ];  // offsets q this N tile uses, in order
  __shared__ int s_nact;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm0 = (warp % kWarpsM) * 32;
  const int wn0 = (warp / kWarpsM) * (kWN * 8);
  const int row_tiles = (p.rows + TM - 1) / TM;
  const int b = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x - b * row_tiles) * TM;
  const int n0 = blockIdx.y * TN;

  if (tid < kMaxClasses * kMaxQ) s_tap[tid] = p.taps[tid / kMaxQ][tid % kMaxQ];
  if (tid == 0) {
    const int r_lo = n0 / p.cout;
    const int r_hi = (min(n0 + TN, p.n) - 1) / p.cout;
    int cnt = 0;
    for (int q = 0; q < p.q; ++q) {
      bool used = false;
      for (int r = r_lo; r <= r_hi; ++r) used = used || p.taps[r][q] >= 0;
      if (used) s_act[cnt++] = q;
    }
    for (int i = cnt; i < kMaxQ; ++i) s_act[i] = 0;
    s_nact = cnt;
  }
  __syncthreads();

  const int depth = s_nact * p.cw;  // reduction depth of one chunk
  const int ksteps = (depth + 7) >> 3;
  const int nchunks = depth > 0 ? (p.cin + p.cw - 1) / p.cw : 0;

  // Copy assignment, fixed per thread: which channels of an x row and which
  // columns of a w row it copies (kThreads is a multiple of both row widths).
  const int x_per = vec_x ? 4 : 1;
  const int x_row_copies = p.cw / x_per;
  const int xc = (tid % x_row_copies) * x_per;
  const int xr0 = tid / x_row_copies, xr_step = kThreads / x_row_copies;
  const int w_per = vec_w ? 4 : 1;
  const int w_row_copies = TN / w_per;
  const int wc = (tid % w_row_copies) * w_per;
  const int wr0 = tid / w_row_copies, wr_step = kThreads / w_row_copies;
  const int wn = n0 + wc;
  const bool wn_ok = wn < p.n;
  const int wr = wn_ok ? wn / p.cout : 0;  // class and channel of that column
  const int wco = wn - wr * p.cout;
  const long long xb = (long long)b * p.l * p.cin;
  const int in0 = p.sigma * t0 + p.o_min;  // input row of staged row 0

  auto stage = [&](int st, int c) {
    float* xs = smem + st * p.stage_floats;
    float* ws = xs + p.x_rows * p.x_stride;
    const int c0 = c * p.cw;
    const bool c_ok = c0 + xc < p.cin;
    for (int rr = xr0; rr < p.x_rows; rr += xr_step) {
      const int i = in0 + rr;
      const bool ok = c_ok && i >= 0 && i < p.l;
      const float* src = ok ? x + xb + (long long)i * p.cin + c0 + xc : x;
      float* dst = xs + rr * p.x_stride + xc;
      if (vec_x) cp_async16(dst, src, ok); else cp_async4(dst, src, ok);
    }
    for (int kk = wr0; kk < ksteps * 8; kk += wr_step) {
      const int ci = kk & (p.cw - 1);
      int tap = -1;
      if (kk < depth && wn_ok && c0 + ci < p.cin) tap = s_tap[wr * kMaxQ + s_act[kk >> p.cw_shift]];
      const bool ok = tap >= 0;
      const float* src = ok ? w + ((long long)tap * p.cin + c0 + ci) * p.cout + wco : w;
      float* dst = ws + kk * p.w_stride + wc;
      if (vec_w) cp_async16(dst, src, ok); else cp_async4(dst, src, ok);
    }
  };

  // acc: the sum, by IEEE f32 adds of the partial sums of each pair of
  // k-steps. The tensor cores add with truncation, so one long chain of
  // products into one accumulator would drift toward zero by about an ulp a
  // product step; a pair's partial sum starts from zero, and its truncation
  // errors take the sign of that partial sum, which varies from pair to pair.
  float acc[kWM][kWN][4];
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int j = 0; j < kWN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // staged row of output row m (tile-local) at offset 0
  int arow[kWM][2];
#pragma unroll
  for (int i = 0; i < kWM; ++i) {
    const int m = wm0 + i * 16 + g;
    arow[i][0] = p.sigma * m * p.x_stride;
    arow[i][1] = p.sigma * (m + 8) * p.x_stride;
  }

  // Raw fragments of two k-steps. Within a k-step the thread's k = tig and
  // k = tig + 4 are reduction indices kk = 8*ks + 2*tig and kk + 1 (any
  // bijection that A and B share gives the same sum), so its two A values of
  // a row are adjacent floats: one 8-byte load.
  struct Frags {
    float2 a[2][kWM][2];
    float b[2][kWN][2];
  };
  auto load = [&](const float* xs, const float* ws, int ks, Frags& f, int h) {
    const int kk = ks * 8 + 2 * tig;
    const bool v = kk < depth;  // depth is a multiple of 4, kk even: kk + 1 too
    const int ao = s_act[kk >> p.cw_shift] * p.x_stride + (kk & (p.cw - 1));
#pragma unroll
    for (int i = 0; i < kWM; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        f.a[h][i][r] = v ? *reinterpret_cast<const float2*>(xs + arow[i][r] + ao)
                         : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kWN; ++j) {
      const int n = wn0 + j * 8 + g;
      f.b[h][j][0] = ws[kk * p.w_stride + n];
      f.b[h][j][1] = ws[(kk + 1) * p.w_stride + n];
    }
  };
  auto load_pair = [&](const float* xs, const float* ws, int ks, Frags& f) {
    load(xs, ws, ks, f, 0);
    if (ks + 1 < ksteps) load(xs, ws, ks + 1, f, 1);
  };
  // small*big, big*small, then big*big of one k-step into part (the first
  // k-step of a pair starts part from zero)
  auto step = [&](const Frags& f, int h, float (&part)[kWM][kWN][4]) {
    uint32_t a_big[kWM][4], a_small[kWM][4];
#pragma unroll
    for (int i = 0; i < kWM; ++i) {
      split(f.a[h][i][0].x, a_big[i][0], a_small[i][0]);  // (g, k)
      split(f.a[h][i][1].x, a_big[i][1], a_small[i][1]);  // (g + 8, k)
      split(f.a[h][i][0].y, a_big[i][2], a_small[i][2]);  // (g, k + 4)
      split(f.a[h][i][1].y, a_big[i][3], a_small[i][3]);  // (g + 8, k + 4)
    }
#pragma unroll
    for (int j = 0; j < kWN; ++j) {
      uint32_t b_big[2], b_small[2];
      split(f.b[h][j][0], b_big[0], b_small[0]);
      split(f.b[h][j][1], b_big[1], b_small[1]);
#pragma unroll
      for (int i = 0; i < kWM; ++i) {
        if (h == 0) mma_tf32_first(part[i][j], a_small[i], b_big);
        else mma_tf32(part[i][j], a_small[i], b_big);
        mma_tf32(part[i][j], a_big[i], b_small);
        mma_tf32(part[i][j], a_big[i], b_big);
      }
    }
  };
  // One pair of k-steps from `cur`, summed from zero and folded into acc,
  // while the next pair's fragments load into `nxt`.
  auto run_pair = [&](const float* xs, const float* ws, int ks, const Frags& cur, Frags& nxt) {
    if (ks + 2 < ksteps) load_pair(xs, ws, ks + 2, nxt);
    float part[kWM][kWN][4];
    step(cur, 0, part);
    if (ks + 1 < ksteps) step(cur, 1, part);
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int j = 0; j < kWN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) stage(s, s);
    cp_async_commit();
  }
  Frags f0, f1;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + kStages - 1 < nchunks) stage((c + kStages - 1) % kStages, c + kStages - 1);
    cp_async_commit();
    const float* xs = smem + (c % kStages) * p.stage_floats;
    const float* ws = xs + p.x_rows * p.x_stride;
    load_pair(xs, ws, 0, f0);
    for (int ks = 0; ks < ksteps; ks += 4) {
      run_pair(xs, ws, ks, f0, f1);
      if (ks + 2 < ksteps) run_pair(xs, ws, ks + 2, f1, f0);
    }
  }
  cp_async_wait<0>();

  // The thread's columns n = n0 + wn0 + 8*j + 2*tig + e: class, channel and
  // bias, worked out once. With Cout even, columns 2*tig and 2*tig + 1 are
  // one class and adjacent channels: one 8-byte store.
  const bool pairs = p.cout % 2 == 0 && ((uintptr_t)y & 7) == 0;
  int col_r[kWN][2], col_co[kWN][2];
  float col_bias[kWN][2];
#pragma unroll
  for (int j = 0; j < kWN; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn0 + j * 8 + 2 * tig + e;
      col_r[j][e] = n < p.n ? n / p.cout : p.lout;  // p.lout: masked below
      col_co[j][e] = n < p.n ? n - col_r[j][e] * p.cout : 0;
      col_bias[j][e] = (bias != nullptr && n < p.n) ? bias[col_co[j][e]] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kWM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm0 + i * 16 + g + 8 * h;
      if (t >= p.rows) continue;
      float* yb = y + (long long)b * p.lout * p.cout;
#pragma unroll
      for (int j = 0; j < kWN; ++j) {
        float v0 = acc[i][j][2 * h] + col_bias[j][0];
        float v1 = acc[i][j][2 * h + 1] + col_bias[j][1];
        if (relu) {  // uniform over the grid
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int yrow0 = p.classes * t + col_r[j][0];
        if (pairs) {
          if (yrow0 < p.lout) {
            *reinterpret_cast<float2*>(yb + (long long)yrow0 * p.cout + col_co[j][0]) =
                make_float2(v0, v1);
          }
        } else {
          const int yrow1 = p.classes * t + col_r[j][1];
          if (yrow0 < p.lout) yb[(long long)yrow0 * p.cout + col_co[j][0]] = v0;
          if (yrow1 < p.lout) yb[(long long)yrow1 * p.cout + col_co[j][1]] = v1;
        }
      }
    }
  }
}

template <int TN, int kWarpsM, int kWarpsN>
cudaError_t launch_tile(const float* x, const float* w, const float* bias, float* y,
                        const Plan& p, int vec_x, int vec_w, int relu, cudaStream_t stream) {
  auto kernel = igemm_conv<TN, kWarpsM, kWarpsN>;
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const long long gx = (long long)p.batch * ((p.rows + p.tile_m - 1) / p.tile_m);
  const int gy = (p.n + TN - 1) / TN;
  if (gx >= (1LL << 31) || gy > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), 32 * kWarpsM * kWarpsN, p.smem_bytes, stream>>>(
      x, w, bias, y, p, vec_x, vec_w, relu);
  return cudaGetLastError();
}

// The plan must be the one ops/igemm.py computed; anything outside the
// kernel's envelope is refused with cudaErrorInvalidValue.
inline bool plan_ok(const Plan& p) {
  if (p.k < 1 || p.k > kMaxK || p.stride < 1 || p.stride > kMaxStride) return false;
  if (p.classes < 1 || p.classes > kMaxClasses || p.q < 1 || p.q > kMaxQ) return false;
  if (p.sigma < 1 || p.sigma > kMaxStride || p.cin < 1 || p.cout < 1) return false;
  if (p.n != p.classes * p.cout) return false;
  if (p.cw < 4 || p.cw > 32 || (1 << p.cw_shift) != p.cw) return false;
  if (p.x_rows != (p.tile_m - 1) * p.sigma + p.q || p.x_stride < p.cw || p.x_stride % 4) return false;
  if (p.w_rows < ((p.q * p.cw + 7) & ~7) || p.w_stride < p.tile_n || p.w_stride % 4) return false;
  if (p.stage_floats != p.x_rows * p.x_stride + p.w_rows * p.w_stride) return false;
  if (p.smem_bytes != kStages * p.stage_floats * (int)sizeof(float) || p.smem_bytes > kMaxSmem) return false;
  for (int r = 0; r < kMaxClasses; ++r)
    for (int q = 0; q < kMaxQ; ++q)
      if (p.taps[r][q] < -1 || p.taps[r][q] >= p.k || (p.taps[r][q] >= 0 && (r >= p.classes || q >= p.q)))
        return false;
  return true;
}

// One launch on `stream`, y = relu ? max(sum + bias, 0) : sum + bias; returns
// a cudaError_t as an int (0: launched).
inline int run(const float* x, const float* w, const float* bias, float* y, const Plan& p,
               int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
  if ((long long)p.batch * p.lout * p.cout == 0) return 0;
  const int vec_x = (p.cin % 4 == 0 && ((uintptr_t)x & 15) == 0) ? 1 : 0;
  const int vec_w = (p.cout % 4 == 0 && ((uintptr_t)w & 15) == 0) ? 1 : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.tile_n == 64 && p.tile_m == 64) err = launch_tile<64, 2, 2>(x, w, bias, y, p, vec_x, vec_w, relu, s);
  else if (p.tile_n == 64 && p.tile_m == 128) err = launch_tile<64, 4, 2>(x, w, bias, y, p, vec_x, vec_w, relu, s);
  else if (p.tile_n == 32 && p.tile_m == 128) err = launch_tile<32, 4, 1>(x, w, bias, y, p, vec_x, vec_w, relu, s);
  else if (p.tile_n == 16 && p.tile_m == 128) err = launch_tile<16, 4, 1>(x, w, bias, y, p, vec_x, vec_w, relu, s);
  else if (p.tile_n == 8 && p.tile_m == 128) err = launch_tile<8, 4, 1>(x, w, bias, y, p, vec_x, vec_w, relu, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace igemm
