// The one-pass bf16 implicit-GEMM core of the conv kernels (convt1d.cu and
// conv1d.cu with their bf16 flag set): operands rounded to bf16 once, on
// their way into shared memory, fragments by ldmatrix, products by
// mma.sync.m16n8k16 bf16 with f32 sums.
//
// Replaces, through those entry points (the TPU's Precision.DEFAULT pass of
// the same products):
//   melogan_tpu/ops/pallas/conv1d.py::_convt_kernel  (transposed conv)
//   melogan_tpu/ops/pallas/conv1d.py::_conv1d_kernel (strided conv)
//
// What it computes: the generalised conv of ops/igemm.py,
//   Y[b, t, n] = bias[n mod Cout]
//              + sum_{q < Q} sum_ci R(X[b, sigma*t + o_min + q, ci]) * R(W'[q, ci, n])
// with R the rounding of an f32 to bf16, to nearest with ties to even
// (torch's .to(torch.bfloat16): inf stays inf, a NaN stays a NaN). A product
// of two bf16 values is exact in f32; the sums are f32, bias and Y f32. The
// tap table, the classes and the column order are those of igemm_tf32x3.cuh; the
// plan (ops/igemm.py::Bf16Plan) arrives by value.
//
// Bound on an H100 SXM: x, w and y stay f32 at the port's public functions,
// so the kernel reads f32 and writes f32. At the decoder's and the emotion
// discriminator's widths that makes the bytes the bound at the dense bf16
// rate (989.4 TFLOP/s): 100-200 flops per f32 byte against the card's 295.
//
// Design (the choices measured on an H100 by melogan_torch/profile_conv_bf16.py):
// - A CTA takes a TM x TN tile of rows t and columns n; a warp holds
//   (16*kMT) x (8*kNT) sums. Wide layers: 256 rows of 16 warps of 32 x 32
//   (one CTA an SM) where those fill the card, else 128 of 4 warps of
//   64 x 32, or 64 of 4 of 32 x 32; narrow N (Cout = 4): 128 x 8/16/32. The
//   row tile is a run of one sample's rows, or several whole samples where
//   a sample has at most half the tile's rows (the decoder's 64-row stage
//   1), each with its own halo. The grid is one dimension, N tiles fastest.
//   Larger row tiles pay most: every row tile copies and rounds its w block
//   again, and the time followed neither the fragment bytes nor the staging
//   bytes a multiply-add.
// - Staging, chunk by chunk of cw input channels: cp.async copies f32 rows
//   of x and the tap-table gather of w into a landing ring (1 or 2 stages).
//   Each thread then rounds the elements it copied itself (its own
//   cp.async.wait_group makes them visible to it, no barrier needed) into a
//   bf16 tile, one cvt.rn.bf16x2 for two values: every element is rounded
//   once per CTA and chunk, and every fragment after that reads bf16. The
//   bf16 tiles are double-buffered, so one __syncthreads a chunk suffices.
// - The A tile, two ways:
//   - halo (Cin > 8, cw = 16, 32 or 64): the input rows the tile needs are
//     staged once a chunk, split by row mod sigma into planes (only the
//     min(sigma, Q) planes some tap reads), so output row m of tap q reads
//     row m + q div sigma of plane q mod sigma (of m's sample): consecutive m are
//     consecutive rows at any stride, and the 16-byte ldmatrix rows of a
//     fragment, 16 + 8 or more bf16 apart, hit eight distinct bank groups.
//     A k16 step lies inside one tap; each lane passes its own row address,
//     so the tap shift costs nothing.
//   - im2col (Cin <= 8, cw = 4 or 8): one row per output row, (q, ci)
//     flattened and padded to a power of two of at least 16, so a k16 step
//     spans 2 or 4 taps instead of wasting 12 of 16 on 4 channels.
// - The W tile is stored k-major (rows (q, ci), TN + 8 or TN bf16 wide);
//   ldmatrix.trans gives the column-major B fragments of two n8 tiles at a
//   time, free of bank conflicts.
// - Accuracy: the tensor cores add with truncation, so the products of each
//   pair of k16 steps are summed from zero and folded into the f32 sum by
//   IEEE adds, as the f32 core does for its pairs of k8 steps.
// - No split of the reduction across CTAs: the same inputs give the same
//   bits from launch to launch.
// What limits it (PERF.md): at the ED's widest layer the copies alone
// take two thirds of the time and overlap poorly with the products. Later
// work: a persistent CTA that keeps its w block in shared memory, x by TMA,
// producer and consumer warps, wgmma.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm_bf16 {

constexpr int kMaxClasses = 16;
constexpr int kMaxQ = 8;
constexpr int kMaxK = 7;
constexpr int kMaxStride = 16;
constexpr int kMaxSmem = 227 * 1024;

// Field for field the ctypes structure ops/igemm.py::CBf16Plan.
struct Plan {
  int batch, l, cin, cout, k, stride;
  int n, classes, rows, lout;            // GEMM columns, tap classes, rows per sample, output rows
  int sigma, o_min, q;                   // input row of (t, q) is sigma*t + o_min + q
  int cw, cw_shift, chunks;              // input channels per chunk, log2(cw), chunks of Cin
  int tile_m, tile_n, warp_m;            // CTA tile; rows a warp holds (32 or 64)
  int segs, seg;                         // samples a row tile holds, output rows of each
  int planes, plane_rows;                // halo: planes staged, rows of each
  int a_rows, a_cols, a_cols_shift, a_stride;  // A tile: rows, f32 width, log2, bf16 row stride
  int w_rows, w_stride;                  // W tile: reduction rows, bf16 row stride
  int stages, land_floats, tile_halves, table_ints, smem_bytes;
  signed char taps[kMaxClasses][kMaxQ];  // w tap of (class, offset), or -1
};

__device__ __forceinline__ void cp_async16(void* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// lo and hi rounded to bf16 (round to nearest even) and packed, lo in the
// low half: the order of two adjacent bf16 in memory.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d (+)= A (16x16, row) * B (16x8, col), bf16 inputs, f32 sums; with
// `first` the sum starts from zero. Fragments, with g = lane / 4 and
// i = lane % 4, two bf16 a register: a0 (g, 2i..), a1 (g+8, 2i..),
// a2 (g, 2i+8..), a3 (g+8, 2i+8..); b0 (rows 2i.., col g), b1 (rows 2i+8..,
// col g); d0 (g, 2i), d1 (g, 2i+1), d2 (g+8, 2i), d3 (g+8, 2i+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(  // not volatile: independent products may be reordered
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// CTA: kWarpsM x kWarpsN warps; a warp takes 16*kMT rows (kMT m16 tiles) by
// 8*kNT columns (kNT n8 tiles).
template <int kMT, int kNT, int kWarpsM, int kWarpsN>
__global__ void __launch_bounds__(32 * kWarpsM * kWarpsN)
igemm_bf16_conv(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                const __grid_constant__ Plan p, int vec_x, int vec_w) {
  constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  constexpr int TM = 16 * kMT * kWarpsM;
  constexpr int TN = 8 * kNT * kWarpsN;
  static_assert(kThreads >= kMaxClasses * kMaxQ, "tap table copy");
  static_assert(TN <= kThreads && 64 <= kThreads, "one column of a staged row a thread");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ signed char s_tap[kMaxClasses * kMaxQ];
  __shared__ int s_act[kMaxQ];  // offsets q this N tile uses, in order
  __shared__ int s_koff[16];    // A tile offset (bf16) of each cw-group of the reduction
  __shared__ int s_nact;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm0 = (warp % kWarpsM) * (16 * kMT);
  const int wn0 = (warp / kWarpsM) * (8 * kNT);
  // One grid dimension, N tiles fastest: the CTAs of one row tile run
  // together and read its x rows from HBM once, then from L2. The row tile:
  // seg output rows t0.. of each of segs samples b0.. (one sample and
  // seg = TM, or whole samples of seg = rows <= TM / 2 rows each).
  const int n_tiles = (p.n + TN - 1) / TN;
  const int mt = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x - mt * n_tiles) * TN;
  const int row_tiles = (p.rows + p.seg - 1) / p.seg;
  const int bt = mt / row_tiles;
  const int b0 = bt * p.segs;
  const int t0 = (mt - bt * row_tiles) * p.seg;
  const int seg_rows = p.seg + (p.q - 1) / p.sigma;  // halo: a plane's rows of one segment
  const bool im2col = p.cw <= 8;
  const int in0 = p.sigma * t0 + p.o_min;  // input row of output row 0 at offset 0

  float* land = reinterpret_cast<float*>(smem);
  uint16_t* tiles = reinterpret_cast<uint16_t*>(smem + (size_t)p.stages * p.land_floats * 4);
  int* s_src = reinterpret_cast<int*>(smem + (size_t)p.stages * p.land_floats * 4 +
                                      (size_t)p.tile_halves * 4);

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
  const int nact = s_nact;
  // groups of cw columns a staged A row holds: 1 (halo), a_cols / cw (im2col)
  const int groups_shift = p.a_cols_shift - p.cw_shift;
  if (tid < 16) {
    int off = tid * p.cw;  // im2col: group qa starts at column qa * cw
    if (!im2col) {
      const int q = s_act[min(tid, kMaxQ - 1)];
      off = ((q % p.sigma) * p.plane_rows + q / p.sigma) * p.a_stride;
    }
    s_koff[tid] = off;
  }
  // the x row (times Cin, from sample b0) of each staged (row, group), or -1
  // for zeros
  for (int e = tid; e < p.table_ints; e += kThreads) {
    int i, sg;
    if (im2col) {
      const int qa = e & ((1 << groups_shift) - 1), m = e >> groups_shift;
      sg = m / p.seg;
      i = qa < nact ? in0 + p.sigma * (m - sg * p.seg) + s_act[qa] : -1;
    } else {
      const int plane = e / p.plane_rows, j = e - plane * p.plane_rows;
      sg = j / seg_rows;
      i = in0 + p.sigma * (j - sg * seg_rows) + plane;
    }
    const bool ok = i >= 0 && i < p.l && sg < p.segs && b0 + sg < p.batch;
    s_src[e] = ok ? (sg * p.l + i) * p.cin : -1;
  }
  __syncthreads();

  const int depth = nact * p.cw;  // reduction depth of one chunk
  const int ksteps = (depth + 15) >> 4;
  const int nchunks = depth > 0 ? p.chunks : 0;

  // Copy assignment, fixed per thread and the same for every chunk, so that
  // each thread rounds exactly the landing elements it copied.
  const int x_per = vec_x ? 4 : 1;
  const int x_units_shift = p.a_cols_shift - (vec_x ? 2 : 0);  // copies per staged row, log2
  const int xc = (tid & ((1 << x_units_shift) - 1)) * x_per;
  const int xg = xc >> p.cw_shift, xci = xc & (p.cw - 1);
  const int xr0 = tid >> x_units_shift, xr_step = kThreads >> x_units_shift;
  const int w_per = vec_w ? 4 : 1;
  const int w_units = TN / w_per;
  const int wc = (tid % w_units) * w_per;
  const int wr0 = tid / w_units, wr_step = kThreads / w_units;
  const int wn = n0 + wc;
  const bool wn_ok = wn < p.n;
  const int wr = wn_ok ? wn / p.cout : 0;  // class and channel of that column
  const int wco = wn - wr * p.cout;
  const long long xb = (long long)b0 * p.l * p.cin;
  const int a_land = p.a_rows * p.a_cols;
  const int a_halves = p.a_rows * p.a_stride;

  auto stage = [&](int st, int c) {
    float* la = land + st * p.land_floats;
    float* lw = la + a_land;
    const int c0 = c * p.cw;
    const bool c_ok = c0 + xci < p.cin;
    for (int rr = xr0; rr < p.a_rows; rr += xr_step) {
      const int off = s_src[(rr << groups_shift) + xg];
      const bool ok = c_ok && off >= 0;
      const float* src = ok ? x + xb + off + c0 + xci : x;
      float* dst = la + rr * p.a_cols + xc;
      if (vec_x) cp_async16(dst, src, ok); else cp_async4(dst, src, ok);
    }
    for (int kk = wr0; kk < ksteps * 16; kk += wr_step) {
      const int ci = kk & (p.cw - 1);
      int tap = -1;
      if (kk < depth && wn_ok && c0 + ci < p.cin) tap = s_tap[wr * kMaxQ + s_act[kk >> p.cw_shift]];
      const bool ok = tap >= 0;
      const float* src = ok ? w + ((long long)tap * p.cin + c0 + ci) * p.cout + wco : w;
      float* dst = lw + kk * TN + wc;
      if (vec_w) cp_async16(dst, src, ok); else cp_async4(dst, src, ok);
    }
  };

  // Rounds rows r0, r0 + step, ... < rows of s (stride ss floats) into d
  // (stride ds bf16): 4 adjacent values a row (vec) or 1.
  auto round_rows = [&](const float* s, int ss, uint16_t* d, int ds, int r0, int step, int rows,
                        int vec) {
    for (int r = r0; r < rows; r += step) {
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(s + r * ss);
        *reinterpret_cast<uint2*>(d + r * ds) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      } else {
        d[r * ds] = __bfloat16_as_ushort(__float2bfloat16_rn(s[r * ss]));
      }
    }
  };
  // This thread's landed elements of stage st, rounded into bf16 buffer bb.
  auto round_in = [&](int st, int bb) {
    const float* la = land + st * p.land_floats;
    uint16_t* ta = tiles + bb * p.tile_halves;
    round_rows(la + xc, p.a_cols, ta + xc, p.a_stride, xr0, xr_step, p.a_rows, vec_x);
    round_rows(la + a_land + wc, TN, ta + a_halves + wc, p.w_stride, wr0, wr_step, ksteps * 16, vec_w);
  };

  // acc: the sum, by IEEE f32 adds of the partial sums of each pair of k16
  // steps (each summed from zero on the tensor cores).
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Lane addresses (bytes, shared window) relative to a bf16 buffer. A: row
  // wm0 + 16i + lane % 16, columns 8 * (lane / 16) on; B (ldmatrix.trans):
  // reduction row (lane / 8 % 2) * 8 + lane % 8, columns wn0 + 8 * (lane / 16).
  const unsigned tiles_s = static_cast<unsigned>(__cvta_generic_to_shared(tiles));
  unsigned a_lane[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int m = wm0 + i * 16 + (lane & 15);  // its staged row: halo, m's segment's rows
    const int row = im2col ? m : (m / p.seg) * seg_rows + m % p.seg;
    a_lane[i] = 2u * (row * p.a_stride + (lane >> 4) * 8);
  }
  const unsigned b_lane =
      2u * (a_halves + ((((lane >> 3) & 1) * 8 + (lane & 7)) * p.w_stride + wn0 + (lane >> 4) * 8));

  struct Frags {
    uint32_t a[kMT][4];
    uint32_t b[kNT][2];
  };
  auto load = [&](unsigned buf, int ks, Frags& f) {
    const int kk = ks * 16;
    const unsigned ao = buf + 2u * (s_koff[kk >> p.cw_shift] + (kk & (p.cw - 1)));
#pragma unroll
    for (int i = 0; i < kMT; ++i) ldmatrix_x4(f.a[i], ao + a_lane[i]);
    const unsigned bo = buf + b_lane + 2u * kk * p.w_stride;
#pragma unroll
    for (int j = 0; j + 1 < kNT; j += 2)
      ldmatrix_x4_trans(f.b[j][0], f.b[j][1], f.b[j + 1][0], f.b[j + 1][1], bo + 2u * 8 * j);
    if constexpr (kNT % 2 == 1)
      ldmatrix_x2_trans(f.b[kNT - 1][0], f.b[kNT - 1][1], bo + 2u * 8 * (kNT - 1));
  };
  auto step = [&](const Frags& f, bool first, float (&part)[kMT][kNT][4]) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (first) mma_bf16_first(part[i][j], f.a[i], f.b[j][0], f.b[j][1]);
        else mma_bf16(part[i][j], f.a[i], f.b[j][0], f.b[j][1]);
      }
  };

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < p.stages && s < nchunks) stage(s, s);
    if (s < p.stages) cp_async_commit();
  }
  Frags f0, f1;
  for (int c = 0; c < nchunks; ++c) {
    if (p.stages == 2) cp_async_wait<1>(); else cp_async_wait<0>();  // this thread's chunk c
    const int st = p.stages == 2 ? (c & 1) : 0;
    round_in(st, c & 1);
    if (c + p.stages < nchunks) stage(st, c + p.stages);
    cp_async_commit();
    __syncthreads();  // bf16 tile c complete; every warp is done with tile c - 2
    const unsigned buf = tiles_s + 2u * (c & 1) * p.tile_halves;
    load(buf, 0, f0);
    for (int ks = 0; ks < ksteps; ks += 2) {
      float part[kMT][kNT][4];
      const bool two = ks + 1 < ksteps;
      if (two) load(buf, ks + 1, f1);
      step(f0, true, part);
      if (ks + 2 < ksteps) load(buf, ks + 2, f0);
      if (two) step(f1, false, part);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
  }
  cp_async_wait<0>();

  // The store of igemm_tf32x3.cuh: the thread's columns n = n0 + wn0 + 8*j + 2*tig
  // + e, class, channel and bias worked out once; with Cout even, columns
  // 2*tig and 2*tig + 1 are one class and adjacent channels: one 8-byte store.
  const bool pairs = p.cout % 2 == 0 && ((uintptr_t)y & 7) == 0;
  int col_r[kNT][2], col_co[kNT][2];
  float col_bias[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn0 + j * 8 + 2 * tig + e;
      col_r[j][e] = n < p.n ? n / p.cout : p.lout;  // p.lout: masked below
      col_co[j][e] = n < p.n ? n - col_r[j][e] * p.cout : 0;
      col_bias[j][e] = (bias != nullptr && n < p.n) ? bias[col_co[j][e]] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm0 + i * 16 + g + 8 * h, sg = m / p.seg;
      const int t = t0 + m - sg * p.seg;
      if (t >= p.rows || sg >= p.segs || b0 + sg >= p.batch) continue;
      float* yb = y + (long long)(b0 + sg) * p.lout * p.cout;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float v0 = acc[i][j][2 * h] + col_bias[j][0];
        const float v1 = acc[i][j][2 * h + 1] + col_bias[j][1];
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

template <int kMT, int kNT, int kWarpsM, int kWarpsN>
cudaError_t launch_tile(const float* x, const float* w, const float* bias, float* y,
                        const Plan& p, int vec_x, int vec_w, cudaStream_t stream) {
  auto kernel = igemm_bf16_conv<kMT, kNT, kWarpsM, kWarpsN>;
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const long long gx = (long long)((p.batch + p.segs - 1) / p.segs) * ((p.rows + p.seg - 1) / p.seg) *
                       ((p.n + p.tile_n - 1) / p.tile_n);
  if (gx >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<(unsigned)gx, 32 * kWarpsM * kWarpsN, p.smem_bytes, stream>>>(
      x, w, bias, y, p, vec_x, vec_w);
  return cudaGetLastError();
}

// The plan must be the one ops/igemm.py computed; anything outside the
// kernel's envelope is refused with cudaErrorInvalidValue.
inline bool plan_ok(const Plan& p) {
  if (p.k < 1 || p.k > kMaxK || p.stride < 1 || p.stride > kMaxStride) return false;
  if (p.classes < 1 || p.classes > kMaxClasses || p.q < 1 || p.q > kMaxQ) return false;
  if (p.sigma < 1 || p.sigma > kMaxStride || p.cin < 1 || p.cout < 1) return false;
  if (p.n != p.classes * p.cout) return false;
  if (p.cw < 4 || p.cw > 64 || (1 << p.cw_shift) != p.cw) return false;
  if (p.segs < 1 || p.seg < 1 || p.segs * p.seg > p.tile_m) return false;
  if (p.segs > 1 && (p.seg != p.rows || (long long)p.segs * p.l * p.cin >= (1LL << 31))) return false;
  if (p.segs == 1 && p.seg != p.tile_m) return false;
  if (p.a_cols < 16 || p.a_cols > 64 || (1 << p.a_cols_shift) != p.a_cols) return false;
  if (p.cw <= 8) {  // im2col
    if (p.cin > p.cw || p.chunks != 1 || p.a_rows != p.tile_m || p.a_cols < p.q * p.cw) return false;
    if (p.w_rows != p.a_cols) return false;
  } else {  // halo
    if (p.chunks != (p.cin + p.cw - 1) / p.cw || p.a_cols != p.cw) return false;
    if (p.planes != (p.sigma < p.q ? p.sigma : p.q) ||
        p.plane_rows != p.segs * (p.seg + (p.q - 1) / p.sigma)) return false;
    if (p.a_rows != p.planes * p.plane_rows || p.w_rows != p.q * p.cw) return false;
  }
  if (p.a_stride != p.a_cols + 8 || p.w_rows % 16) return false;
  if (p.w_stride < p.tile_n || p.w_stride % 8 || (p.w_stride / 8) % 2 != 1) return false;
  if (p.stages < 1 || p.stages > 2) return false;
  if (p.land_floats != p.a_rows * p.a_cols + p.w_rows * p.tile_n) return false;
  if (p.tile_halves != p.a_rows * p.a_stride + p.w_rows * p.w_stride) return false;
  if (p.table_ints != p.a_rows * (p.a_cols / p.cw)) return false;
  if (p.smem_bytes != p.stages * p.land_floats * 4 + p.tile_halves * 4 + p.table_ints * 4 ||
      p.smem_bytes > kMaxSmem) return false;
  for (int r = 0; r < kMaxClasses; ++r)
    for (int q = 0; q < kMaxQ; ++q)
      if (p.taps[r][q] < -1 || p.taps[r][q] >= p.k || (p.taps[r][q] >= 0 && (r >= p.classes || q >= p.q)))
        return false;
  return true;
}

// One launch on `stream`, y = sum + bias; returns a cudaError_t as an int
// (0: launched).
inline int run(const float* x, const float* w, const float* bias, float* y, const Plan& p,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
  if ((long long)p.batch * p.lout * p.cout == 0) return 0;
  const int vec_x = (p.cin % 4 == 0 && ((uintptr_t)x & 15) == 0) ? 1 : 0;
  const int vec_w = (p.cout % 4 == 0 && ((uintptr_t)w & 15) == 0) ? 1 : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tm = p.tile_m, tn = p.tile_n;
  if (p.warp_m == 64) {  // 64 x 32 warp tiles
    if (tm == 128 && tn == 64) err = launch_tile<4, 4, 2, 2>(x, w, bias, y, p, vec_x, vec_w, s);
    else if (tm == 256 && tn == 64) err = launch_tile<4, 4, 4, 2>(x, w, bias, y, p, vec_x, vec_w, s);
    else if (tm == 128 && tn == 128) err = launch_tile<4, 4, 2, 4>(x, w, bias, y, p, vec_x, vec_w, s);
    else err = cudaErrorInvalidValue;
  } else if (p.warp_m == 32) {  // 32 x 32, or 32 x TN for narrow N
    if (tm == 64 && tn == 64) err = launch_tile<2, 4, 2, 2>(x, w, bias, y, p, vec_x, vec_w, s);
    else if (tm == 128 && tn == 64) err = launch_tile<2, 4, 4, 2>(x, w, bias, y, p, vec_x, vec_w, s);
    else if (tm == 256 && tn == 64) err = launch_tile<2, 4, 8, 2>(x, w, bias, y, p, vec_x, vec_w, s);
    else if (tm == 128 && tn == 128) err = launch_tile<2, 4, 4, 4>(x, w, bias, y, p, vec_x, vec_w, s);
    else if (tm == 128 && tn == 32) err = launch_tile<2, 4, 4, 1>(x, w, bias, y, p, vec_x, vec_w, s);
    else if (tm == 128 && tn == 16) err = launch_tile<2, 2, 4, 1>(x, w, bias, y, p, vec_x, vec_w, s);
    else if (tm == 128 && tn == 8) err = launch_tile<2, 1, 4, 1>(x, w, bias, y, p, vec_x, vec_w, s);
    else err = cudaErrorInvalidValue;
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace igemm_bf16
