// The 3xTF32 implicit-GEMM core of the conv kernels' f32 mode (convt1d.cu and
// conv1d.cu with their bf16 flag clear) and of the decoder tail
// (decoder_tail.cu), built for Hopper: operands split into TF32 halves once,
// x by TMA into an mbarrier ring fed by a producer warp, wgmma tf32 products,
// persistent CTAs, and a split of the reduction whose parts are summed in a
// fixed order.
//
// Replaces, through those entry points (the TPU's Precision.HIGHEST passes
// of the same products):
//   melogan_tpu/ops/pallas/conv1d.py::_convt_kernel  (transposed conv)
//   melogan_tpu/ops/pallas/conv1d.py::_conv1d_kernel (strided conv)
// and, through decoder_tail.cu's three launches with the ReLU in the store,
//   melogan_tpu/ops/pallas/decoder.py::_decoder_kernel
//
// What it computes: the generalised conv of ops/igemm.py,
//   Y[b, t, n] = bias[n mod Cout]
//              + sum_{q < Q} sum_ci X[b, sigma*t + o_min + q, ci] * W'[q, ci, n]
// (rows outside [0, L) are zero), column n of tap class r = n div Cout and
// channel co = n mod Cout, row t of class r stored at output row
// classes*t + r (below Lout). f32-accurate through 3xTF32: each operand a is
// split into big = rna(a) and small = rna(a - big), both TF32, and
// small*big + big*small + big*big are summed in f32. The plan
// (ops/igemm.py::Tf32x3Plan) arrives by value.
//
// Bound on an H100 SXM: at the decoder's and the emotion discriminator's
// widths the convs do 100-800 flops per byte of x, w and y, so operations
// bound them: 495/3 = 165 TFLOP/s of f32 work on the tensor cores.
//
// Design:
// - W' once: a prologue kernel (prep_w) gathers w through the tap table into
//   W' blocks, one per (N tile, chunk of cw input channels), splits every
//   value into its big and small TF32 planes and lays each plane out as
//   wgmma's K-major core matrices (8 columns x 4 reduction rows, 128 bytes).
//   An N tile's block holds only the offsets q its columns use (depth
//   nact*cw rounded up to 16, a pair of k8 steps), so a class never
//   multiplies structural zeros of offsets it does not use. The convs run
//   it before every conv launch into their scratch (run); the decoder tail
//   (decoder_tail.cu) runs it once per folded weights and W' layout
//   (prepare) and then only the conv (conv), on W' its caller holds.
// - A CTA: one producer warp and two consumer warpgroups. A consumer
//   warpgroup holds 64 output rows of one sample by TN columns (one wgmma
//   m64nTNk8, TN = 8 ... 128); a work item is two such row tiles by one N
//   tile. Persistent
//   CTAs (one an SM, grid <= 132) walk a static list of units, unit u =
//   item * parts + part, items N tile first, so the CTAs of a wave share
//   one N tile's W' blocks in L2.
// - The ring (2 or 3 stages, a full and an empty mbarrier each): for each
//   chunk the producer's lane 0 copies the W' block by one bulk copy and
//   each warpgroup's window of x rows (63*sigma + Q rows, cw channels) by
//   TMA boxes of a tensor map over (B, L, Cin); rows and channels off the
//   tensor are TMA's zero fill. Where no tensor map can describe x (Cin not
//   a multiple of 4, or a base that is not 16-byte aligned) the whole
//   producer warp copies x by 4-byte cp.async into the same ring (plan and
//   pointer decide, igemm.py::tf32_x_path). No __syncthreads in the loop.
// - Split once: each consumer warpgroup splits its window into big and
//   small planes in shared memory. Halo (cw >= 8): planes by row mod sigma,
//   each of cw/4 channel groups of 16-byte rows, so tap q reads plane
//   q mod sigma from row q div sigma on: a view shifted by whole 16-byte
//   rows, which a wgmma descriptor can start at. im2col (cw = 4): one plane
//   of 64 rows a tap, so a k8 step takes two taps of 4 channels. The second
//   warpgroup starts once the first has split its first window, so one
//   splits while the other's products run (measured: the two splitting at
//   once left the tensor cores idle; splitting the next chunk under one's
//   own products contended for shared memory and was slower).
// - Products: both operands from shared memory through descriptors (no
//   swizzle; K-major core matrices). Each k8 step issues three wgmmas:
//   small*big, big*small, big*big.
// - Accuracy: the tensor cores add with truncation, so each pair of k8
//   steps (six wgmmas) starts from a zeroed accumulator (scale-d = 0) and is
//   folded into the f32 sum by IEEE adds after its wait. The products sit
//   in straight-line code (pairs of whole k8 steps): a wgmma in a branch
//   made ptxas serialize them all.
// - Split-K where the items cannot fill the card (batch 1, the
//   tensor-parallel shards; at most 4 parts): each part writes its partial
//   tile to a
//   workspace, and the CTA that finishes an item's last part (a counter an
//   item, zeroed before every launch) sums the parts in part order
//   0 .. parts-1 from the workspace, whatever order they arrived in. No
//   float is added by an atomic: launches repeat bit for bit.
// - The store works out each column's class and channel and writes
//   8-byte pairs where Cout is even. With `relu` set it stores
//   max(sum + bias, 0) (the decoder tail's first two stages): only the CTA
//   that stores a whole sum applies it, never to a split-K partial tile,
//   and the flag stays out of the products' straight-line code.
// What limits it (PERF.md, profile_conv_bf16 --mode f32 --part ablate): at
// the widest layers the W' blocks, fetched again from L2 for every item,
// and x's windows keep L2 near its rate with the products taken out; the
// split still adds to the products' time. Small shapes wait on the host.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: cuTensorMapEncodeTiled is looked up at run time)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace igemm_tf32x3 {

constexpr int kMaxClasses = 16;
constexpr int kMaxQ = 8;
constexpr int kMaxK = 7;
constexpr int kMaxStride = 16;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxStages = 4;
constexpr int kWgRows = 64;  // rows of a consumer warpgroup (wgmma m64)
constexpr int kConsumers = 2;
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;  // and the producer warp
constexpr int kMaxKSteps = kMaxQ * 32 / 8;
constexpr int kBarrierBytes = 512;  // mbarriers, split-K flags, tap table, k-step tables

// Field for field the ctypes structure ops/igemm.py::CTf32x3Plan.
struct Plan {
  int batch, l, cin, cout, k, stride;
  int n, classes, rows, lout;               // GEMM columns, tap classes, rows per sample, output rows
  int sigma, o_min, q;                      // input row of (t, q) is sigma*t + o_min + q
  int cw, chunks, tile_n, n_tiles;          // channels a chunk, chunks, N tile, N tiles
  int wg_tiles, row_items, items, parts;    // 64-row tiles, pairs of them, work items, split-K parts
  int units, grid;                          // items * parts; persistent CTAs
  int win_rows, box_rows, boxes, land_rows; // a warpgroup's x window and its TMA boxes
  int planes, plane_rows, a_planes, d_max;  // halo planes and rows; im2col planes; W' depth at most
  int stages, w_stage_floats, land_floats, stage_floats, a_floats;
  int wprep_floats, ws_floats, scratch_floats, smem_bytes;
  signed char taps[kMaxClasses][kMaxQ];     // w tap of (class, offset), or -1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The cp.async copies this thread issued so far arrive on `bar` when they land.
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  const int n = valid ? 4 : 0;  // 0 source bytes: the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory writes of this thread become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor, no swizzle: start address, the byte
// offset between the two core matrices of a k8 step (K direction, "leading")
// and between consecutive 8-row groups (M or N direction, "stride").
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// cvt.rna.tf32.f32 on finite values: add half of the dropped 13 bits, cut.
__device__ __forceinline__ float tf32_rna(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
}

// d (+)= A (64 x 8, K-major, shared) * B (8 x N, K-major, shared), tf32
// inputs, f32 sums; scale_d = 0: the sum starts from zero. Each thread holds
// N/2 sums: warp w of the warpgroup rows 16w + g and 16w + g + 8 (g = lane/4),
// for each n8 block j the columns 8j + 2(lane%4) and + 1.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};


// The offsets q that N tile n0.. uses, in order; returns their count.
__device__ __forceinline__ int active_offsets(const Plan& p, const signed char* taps, int n0, int tile_n,
                                              int* act) {
  const int r_lo = n0 / p.cout;
  const int r_hi = (min(n0 + tile_n, p.n) - 1) / p.cout;
  int cnt = 0;
  for (int q = 0; q < p.q; ++q) {
    bool used = false;
    for (int r = r_lo; r <= r_hi; ++r) used = used || taps[r * kMaxQ + q] >= 0;
    if (used) act[cnt++] = q;
  }
  return cnt;
}

// W' row kk (of a chunk) and column nl of an N tile: its float in a plane of
// K-major core matrices (k8 step, n8 group, k half, 8 columns x 4 rows).
__device__ __forceinline__ int w_offset(int kk, int nl, int tile_n) {
  return (((kk >> 3) * (tile_n >> 3) + (nl >> 3)) * 2 + ((kk >> 2) & 1)) * 32 + (nl & 7) * 4 + (kk & 3);
}

// Prologue: the W' blocks of every (N tile, chunk), split into big and small
// planes (big at 0, small at depth * tile_n), and, where `counters` is not
// null, the split-K counters at 0.
__global__ void __launch_bounds__(256) prep_w(const float* __restrict__ w, float* __restrict__ wprep,
                                              int* __restrict__ counters, const __grid_constant__ Plan p) {
  const long long total = (long long)p.n_tiles * p.chunks * p.d_max * p.tile_n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (counters != nullptr && p.parts > 1) {
    for (long long i = first; i < p.items; i += stride) counters[i] = 0;
  }
  for (long long i = first; i < total; i += stride) {
    const int nl = (int)(i % p.tile_n);
    long long rest = i / p.tile_n;
    const int kk = (int)(rest % p.d_max);
    rest /= p.d_max;
    const int c = (int)(rest % p.chunks);
    const int nt = (int)(rest / p.chunks);
    const int n0 = nt * p.tile_n;
    int act[kMaxQ];
    const int nact = active_offsets(p, &p.taps[0][0], n0, p.tile_n, act);
    const int depth = (nact * p.cw + 15) & ~15;
    if (kk >= depth) continue;
    const int qi = kk / p.cw, ci = kk - qi * p.cw, ch = c * p.cw + ci, n = n0 + nl;
    float v = 0.f;
    if (qi < nact && n < p.n && ch < p.cin) {
      const int r = n / p.cout, co = n - r * p.cout;
      const int tap = p.taps[r][act[qi]];
      if (tap >= 0) v = w[((long long)tap * p.cin + ch) * p.cout + co];
    }
    const float big = tf32_rna(v);
    float* block = wprep + ((long long)nt * p.chunks + c) * p.w_stage_floats;
    const int off = w_offset(kk, nl, p.tile_n);
    block[off] = big;
    block[depth * p.tile_n + off] = tf32_rna(v - big);
  }
}

// A unit of work: item, part and their geometry.
struct Unit {
  int item, part, n0, c_lo, c_hi, depth, nact, wt0;
};

__device__ __forceinline__ Unit decode(const Plan& p, const signed char* taps, int u, int* act) {
  Unit w;
  w.item = u / p.parts;
  w.part = u - w.item * p.parts;
  const int nt = w.item / p.row_items;
  w.wt0 = kConsumers * (w.item - nt * p.row_items);
  w.n0 = nt * p.tile_n;
  w.nact = active_offsets(p, taps, w.n0, p.tile_n, act);
  w.depth = (w.nact * p.cw + 15) & ~15;
  w.c_lo = w.part * p.chunks / p.parts;
  w.c_hi = w.nact > 0 ? (w.part + 1) * p.chunks / p.parts : w.c_lo;
  return w;
}

template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
igemm_tf32x3_conv(const float* __restrict__ x, const float* __restrict__ bias, float* __restrict__ y,
                  const float* __restrict__ wprep, float* __restrict__ ws, int* __restrict__ counters,
                  const __grid_constant__ CUtensorMap xmap, const __grid_constant__ Plan p, int use_tma,
                  int relu) {
  constexpr int R = TN / 2;  // sums a consumer thread holds
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;
  float* a_tiles = smem + p.stages * p.stage_floats;
  unsigned char* meta = reinterpret_cast<unsigned char*>(a_tiles + kConsumers * p.a_floats);
  uint64_t* full = reinterpret_cast<uint64_t*>(meta);
  uint64_t* empty = full + kMaxStages;
  volatile int* s_last = reinterpret_cast<volatile int*>(meta + 64);  // two, by unit parity
  signed char* s_tap = reinterpret_cast<signed char*>(meta + 128);
  int* s_koff = reinterpret_cast<int*>(meta + 256);  // [kConsumers][kMaxKSteps]: A offset (bytes) of a k8 step

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < kMaxClasses * kMaxQ) s_tap[tid] = p.taps[tid / kMaxQ][tid % kMaxQ];
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(full + s), use_tma ? 1 : 33);  // TMA: lane 0; cp.async: lane 0 and 32 lanes' copies
      mbar_init(smem_u32(empty + s), kConsumerThreads / 32);  // a warp of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int rt64 = (p.rows + kWgRows - 1) / kWgRows;  // 64-row tiles of a sample
  int act[kMaxQ];

  if (warp == kConsumerThreads / 32) {
    // ---- producer warp ----
    int st = 0;
    uint32_t ph = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit w = decode(p, s_tap, u, act);
      for (int c = w.c_lo; c < w.c_hi; ++c) {
        const uint32_t w_bytes = 2u * w.depth * TN * 4;  // the chunk's W' block
        const int x_windows = kConsumers;                 // and both warpgroups' x
        mbar_wait(smem_u32(empty + st), ph ^ 1);
        float* stage = ring + st * p.stage_floats;
        const uint32_t bar = smem_u32(full + st);
        const float* src = wprep + ((long long)(w.n0 / TN) * p.chunks + c) * p.w_stage_floats;
        if (use_tma) {
          if (lane == 0) {
            uint32_t bytes = w_bytes;
            for (int g = 0; g < x_windows; ++g) {
              const int wt = w.wt0 + g;
              if (wt >= p.wg_tiles) continue;
              const int row0 = p.sigma * (wt % rt64) * kWgRows + p.o_min;
              for (int i = 0; i < p.boxes; ++i) {
                const int r0 = row0 + i * p.box_rows;
                if (r0 < p.l && r0 + p.box_rows > 0) bytes += p.box_rows * p.cw * 4;
              }
            }
            mbar_arrive_expect_tx(bar, bytes);
            if (w_bytes) bulk_load(smem_u32(stage), src, w_bytes, bar);
            for (int g = 0; g < x_windows; ++g) {
              const int wt = w.wt0 + g;
              if (wt >= p.wg_tiles) continue;
              const int b = wt / rt64, row0 = p.sigma * (wt % rt64) * kWgRows + p.o_min;
              float* land = stage + p.w_stage_floats + g * p.land_rows * p.cw;
              for (int i = 0; i < p.boxes; ++i) {
                const int r0 = row0 + i * p.box_rows;
                if (r0 < p.l && r0 + p.box_rows > 0)  // a box wholly off the rows is not copied
                  tma_load_3d(smem_u32(land + i * p.box_rows * p.cw), &xmap, bar, c * p.cw, r0, b);
              }
            }
          }
        } else {
          if (lane == 0) {
            mbar_arrive_expect_tx(bar, w_bytes);
            if (w_bytes) bulk_load(smem_u32(stage), src, w_bytes, bar);
          }
          for (int g = 0; g < x_windows; ++g) {
            const int wt = w.wt0 + g;
            if (wt >= p.wg_tiles) continue;
            const int b = wt / rt64, row0 = p.sigma * (wt % rt64) * kWgRows + p.o_min;
            const uint32_t land = smem_u32(stage + p.w_stage_floats + g * p.land_rows * p.cw);
            const float* xb = x + (long long)b * p.l * p.cin;
            for (int e = lane; e < p.win_rows * p.cw; e += 32) {
              const int r = e / p.cw, ci = e - r * p.cw;
              const int i = row0 + r, ch = c * p.cw + ci;
              const bool ok = i >= 0 && i < p.l && ch < p.cin;
              cp_async4(land + 4u * e, ok ? xb + (long long)i * p.cin + ch : x, ok);
            }
          }
          cp_async_arrive_noinc(bar);
        }
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = tid >> 7, wtid = tid & 127, wwarp = wtid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  float* a_big = a_tiles + wg * p.a_floats;
  float* a_small = a_big + p.a_floats / 2;
  const uint32_t a_s = smem_u32(a_big), a_small_off = 2u * p.a_floats;  // bytes
  const uint32_t lbo_a = p.cw == 4 ? kWgRows * 16 : p.plane_rows * 16;
  const int G = p.cw / 4, g_shift = __ffs(G) - 1;
  const int need_rows = kWgRows + (p.q - 1) / p.sigma;  // halo rows a plane holds
  int* koff = s_koff + wg * kMaxKSteps;
  float acc[R], part[R];
  int st = 0, iter = 0;
  uint32_t ph = 0;
  // The second warpgroup starts its first split once the first has split
  // its window: the two then take turns, one splitting while the other's
  // products run, where they would otherwise split and multiply together.
  if (wg == 1) named_barrier(4, kConsumerThreads);

  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++iter) {
    const Unit w = decode(p, s_tap, u, act);
    const int wt = w.wt0 + wg;
    const bool active = wt < p.wg_tiles;  // uniform over the warpgroup
    const int b = active ? wt / rt64 : 0, t0 = active ? (wt % rt64) * kWgRows : 0;
    const int row0 = p.sigma * t0 + p.o_min;
    const int ksteps = w.depth / 8;  // even
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;

    for (int c = w.c_lo; c < w.c_hi; ++c) {
      mbar_wait(smem_u32(full + st), ph);
      const float* stage = ring + st * p.stage_floats;
      const float* land = stage + p.w_stage_floats + wg * p.land_rows * p.cw;
      if (active) {
        named_barrier(2 + wg, 128);  // every warp is done with the last chunk's planes
        if (c == w.c_lo && wtid < ksteps) {
          int off;
          if (p.cw == 4) {
            off = 2 * wtid * kWgRows * 16;  // im2col: planes 2s and 2s + 1
          } else {
            // a k-step past the offsets (W' rows of zeros) reads the last offset's rows
            const int q = act[min(8 * wtid / p.cw, w.nact - 1)], cg = (8 * wtid % p.cw) / 4;
            off = (((q % p.sigma) * G + cg) * p.plane_rows + q / p.sigma) * 16;
          }
          koff[wtid] = off;
        }
        // the split: this warpgroup's window into big and small planes
        if (p.cw == 4) {
          for (int e = wtid; e < 2 * ksteps * kWgRows; e += 128) {
            const int i = e >> 6, t = e & (kWgRows - 1);
            const int lr = i < w.nact ? p.sigma * t + act[i] : -1;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (lr >= 0 && row0 + lr >= 0 && row0 + lr < p.l) v = *reinterpret_cast<const float4*>(land + 4 * lr);
            const float4 hi = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
            *reinterpret_cast<float4*>(a_big + 4 * e) = hi;
            *reinterpret_cast<float4*>(a_small + 4 * e) =
                make_float4(tf32_rna(v.x - hi.x), tf32_rna(v.y - hi.y), tf32_rna(v.z - hi.z), tf32_rna(v.w - hi.w));
          }
        } else {
          for (int pl = 0; pl < p.planes; ++pl) {
            for (int e = wtid; e < (need_rows << g_shift); e += 128) {
              const int cg = e & (G - 1), j = e >> g_shift;
              const int lr = p.sigma * j + pl;
              float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
              if (lr < p.win_rows && row0 + lr >= 0 && row0 + lr < p.l)
                v = *reinterpret_cast<const float4*>(land + lr * p.cw + 4 * cg);
              const float4 hi = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
              const int o = 4 * ((pl * G + cg) * p.plane_rows + j);
              *reinterpret_cast<float4*>(a_big + o) = hi;
              *reinterpret_cast<float4*>(a_small + o) =
                  make_float4(tf32_rna(v.x - hi.x), tf32_rna(v.y - hi.y), tf32_rna(v.z - hi.z), tf32_rna(v.w - hi.w));
            }
          }
        }
        fence_proxy_async();
        named_barrier(2 + wg, 128);  // planes and k-step table complete
      }
      if (wg == 0 && iter == 0 && c == w.c_lo) named_barrier_arrive(4, kConsumerThreads);
      if (active) {
        const uint32_t wb = smem_u32(stage), wsm = wb + 4u * w.depth * TN;
        // each pair of k8 steps: six wgmmas into part, the first from zero,
        // then part folded into acc
        for (int s = 0; s < ksteps; s += 2) {
          wgmma_fence();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t a = a_s + koff[s + h];
            const uint64_t ab = make_desc(a, lbo_a, 128), as = make_desc(a + a_small_off, lbo_a, 128);
            const uint32_t bo = (s + h) * (TN / 8) * 256;
            const uint64_t bb = make_desc(wb + bo, 128, 256), bs = make_desc(wsm + bo, 128, 256);
            Wgmma<TN>::mma(part, as, bb, h);
            Wgmma<TN>::mma(part, ab, bs, 1);
            Wgmma<TN>::mma(part, ab, bb, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] += part[i];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + st));
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
    if (wg == 0 && iter == 0 && w.c_hi == w.c_lo) named_barrier_arrive(4, kConsumerThreads);

    // ---- epilogue: this warpgroup's 64 x TN sums ----
    bool store = active;
    if (p.parts > 1) {
      float* mine = ws + (((long long)w.item * p.parts + w.part) * kConsumers + wg) * 128 * R + wtid * R;
#pragma unroll
      for (int i = 0; i < R; i += 4)
        *reinterpret_cast<float4*>(mine + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
      __threadfence();
      named_barrier(1, kConsumerThreads);
      if (tid == 0) {
        s_last[iter & 1] = atomicAdd(counters + w.item, 1) == p.parts - 1;
      }
      named_barrier(1, kConsumerThreads);
      store = store && s_last[iter & 1];
      if (store) {  // the last part to finish: every part's tile, summed in part order
        __threadfence();
        const float* first = ws + ((long long)w.item * p.parts * kConsumers + wg) * 128 * R + wtid * R;
#pragma unroll
        for (int i = 0; i < R; i += 4) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(first + i));
          acc[i] = v.x;
          acc[i + 1] = v.y;
          acc[i + 2] = v.z;
          acc[i + 3] = v.w;
        }
        for (int q = 1; q < p.parts; ++q) {  // a part's loads in flight together
          const float* src = first + (long long)q * kConsumers * 128 * R;
#pragma unroll
          for (int i = 0; i < R; i += 4) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(src + i));
            acc[i] += v.x;
            acc[i + 1] += v.y;
            acc[i + 2] += v.z;
            acc[i + 3] += v.w;
          }
        }
      }
    }
    if (store) {
      const bool pairs = p.cout % 2 == 0 && ((uintptr_t)y & 7) == 0;
      float* yb = y + (long long)b * p.lout * p.cout;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int n = w.n0 + 8 * j + 2 * t4;
        int r[2], co[2];
        float bs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = n + e < p.n;
          r[e] = ok ? (n + e) / p.cout : p.lout;  // p.lout: masked below
          co[e] = ok ? n + e - r[e] * p.cout : 0;
          bs[e] = (bias != nullptr && ok) ? bias[co[e]] : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + 16 * wwarp + g8 + 8 * h;
          if (t >= p.rows) continue;
          float v0 = acc[4 * j + 2 * h] + bs[0], v1 = acc[4 * j + 2 * h + 1] + bs[1];
          if (relu) {  // uniform over the grid; a whole sum (split-K parts summed above)
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const int yrow0 = p.classes * t + r[0];
          if (pairs) {
            if (yrow0 < p.lout)
              *reinterpret_cast<float2*>(yb + (long long)yrow0 * p.cout + co[0]) = make_float2(v0, v1);
          } else {
            const int yrow1 = p.classes * t + r[1];
            if (yrow0 < p.lout) yb[(long long)yrow0 * p.cout + co[0]] = v0;
            if (yrow1 < p.lout) yb[(long long)yrow1 * p.cout + co[1]] = v1;
          }
        }
      }
    }
  }
}

// The plan must be the one ops/igemm.py computed; anything outside the
// kernel's envelope is refused with cudaErrorInvalidValue.
inline bool plan_ok(const Plan& p) {
  auto cdiv = [](long long a, long long b) { return (a + b - 1) / b; };
  auto up16 = [](int v) { return (v + 15) & ~15; };
  if (p.k < 1 || p.k > kMaxK || p.stride < 1 || p.stride > kMaxStride) return false;
  if (p.classes < 1 || p.classes > kMaxClasses || p.q < 1 || p.q > kMaxQ) return false;
  if (p.sigma < 1 || p.sigma > kMaxStride || p.cin < 1 || p.cout < 1 || p.rows < 1 || p.batch < 1) return false;
  if (p.n != p.classes * p.cout || (long long)p.l * p.cin >= (1LL << 31)) return false;
  if (p.cw != 4 && p.cw != 8 && p.cw != 16 && p.cw != 32) return false;
  if (p.tile_n != 8 && p.tile_n != 16 && p.tile_n != 32 && p.tile_n != 64 && p.tile_n != 128) return false;
  if (p.chunks != cdiv(p.cin, p.cw) || p.n_tiles != cdiv(p.n, p.tile_n)) return false;
  if (p.wg_tiles != (long long)p.batch * cdiv(p.rows, kWgRows) || p.row_items != cdiv(p.wg_tiles, kConsumers)) return false;
  if (p.items != (long long)p.row_items * p.n_tiles || p.parts < 1 || p.parts > p.chunks) return false;
  if (p.units != (long long)p.items * p.parts || p.grid < 1 || p.grid > p.units) return false;
  if (p.win_rows != (kWgRows - 1) * p.sigma + p.q || p.boxes != cdiv(p.win_rows, 256)) return false;
  if (p.box_rows % 8 || p.box_rows > 256 || p.box_rows * p.boxes < p.win_rows) return false;
  if (p.land_rows != p.boxes * p.box_rows) return false;
  if (p.cw == 4) {
    if (p.planes != 0 || p.plane_rows != kWgRows || p.a_planes != ((p.q + 3) & ~3)) return false;
    if (p.a_floats != 2 * p.a_planes * kWgRows * 4) return false;
  } else {
    if (p.planes != (p.sigma < p.q ? p.sigma : p.q) || p.a_planes != 0) return false;
    if (p.plane_rows < kWgRows + (p.q - 1) / p.sigma) return false;
    if (p.a_floats != 2 * p.planes * (p.cw / 4) * p.plane_rows * 4) return false;
  }
  if (p.d_max != up16(p.q * p.cw) || p.stages < 2 || p.stages > kMaxStages) return false;
  if (p.w_stage_floats != 2 * p.d_max * p.tile_n || p.land_floats != kConsumers * p.land_rows * p.cw) return false;
  if (p.stage_floats != p.w_stage_floats + p.land_floats) return false;
  if (p.wprep_floats != (long long)p.n_tiles * p.chunks * p.w_stage_floats) return false;
  if (p.ws_floats != (p.parts > 1 ? p.items * p.parts * kConsumers * kWgRows * p.tile_n : 0)) return false;
  if (p.scratch_floats != p.wprep_floats + p.ws_floats + (p.parts > 1 ? p.items : 0)) return false;
  if (p.smem_bytes != 4 * (p.stages * p.stage_floats + kConsumers * p.a_floats) + kBarrierBytes ||
      p.smem_bytes > kMaxSmem) return false;
  for (int r = 0; r < kMaxClasses; ++r)
    for (int q = 0; q < kMaxQ; ++q)
      if (p.taps[r][q] < -1 || p.taps[r][q] >= p.k || (p.taps[r][q] >= 0 && (r >= p.classes || q >= p.q)))
        return false;
  return true;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// x's tensor map where one can describe x (the rule of
// ops/igemm.py::tf32_x_path: rows of Cin floats a multiple of 16 bytes, a
// 16-byte aligned base), else *use_tma = 0 and the producer's cp.async.
inline cudaError_t x_map(const float* x, const Plan& p, CUtensorMap* map, int* use_tma) {
  memset(map, 0, sizeof(*map));
  *use_tma = (p.cin % 4 == 0 && ((uintptr_t)x & 15) == 0) ? 1 : 0;
  if (!*use_tma) return cudaSuccess;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)p.cin, (cuuint64_t)p.l, (cuuint64_t)p.batch};
  const cuuint64_t strides[2] = {(cuuint64_t)p.cin * 4, (cuuint64_t)p.l * p.cin * 4};
  const cuuint32_t box[3] = {(cuuint32_t)p.cw, (cuuint32_t)p.box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t launch_prep(const float* w, float* wprep, int* counters, const Plan& p, cudaStream_t stream) {
  const long long prep = (long long)p.n_tiles * p.chunks * p.d_max * p.tile_n;
  const int prep_blocks = (int)((prep + 255) / 256 < 1056 ? (prep + 255) / 256 : 1056);
  prep_w<<<prep_blocks, 256, 0, stream>>>(w, wprep, counters, p);
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_conv(const float* x, const float* bias, float* y, const float* wprep, float* ws, int* counters,
                        const Plan& p, const CUtensorMap& map, int use_tma, int relu, cudaStream_t stream) {
  auto kernel = igemm_tf32x3_conv<TN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, kThreads, p.smem_bytes, stream>>>(x, bias, y, wprep, ws, counters, map, p, use_tma, relu);
  return cudaGetLastError();
}

// The prologue alone on `stream`: W' of plan p (p.wprep_floats floats at
// `wprep`, 16-byte aligned) from w, to be read by later conv() calls.
// Returns a cudaError_t as an int (0: launched).
inline int prepare(const float* w, float* wprep, const Plan& p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(p) || w == nullptr || wprep == nullptr || ((uintptr_t)wprep & 15)) return (int)cudaErrorInvalidValue;
  return (int)launch_prep(w, wprep, nullptr, p, (cudaStream_t)stream);
}

// The conv alone on `stream`, y = sum + bias (relu: max(sum + bias, 0)), on
// W' a prologue made for this plan's layout. Split-K plans (p.parts > 1)
// need p.ws_floats floats at `ws` (16-byte aligned) and p.items counters at
// `counters` that are 0 when the launch starts. Returns a cudaError_t as an
// int (0: launched).
inline int conv(const float* x, const float* wprep, const float* bias, float* y, float* ws, int* counters,
                const Plan& p, int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(p) || wprep == nullptr || ((uintptr_t)wprep & 15)) return (int)cudaErrorInvalidValue;
  if (p.parts > 1 && (ws == nullptr || ((uintptr_t)ws & 15) || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)p.batch * p.lout * p.cout == 0) return 0;
  CUtensorMap map;
  int use_tma = 0;
  err = x_map(x, p, &map, &use_tma);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.tile_n) {
    case 8: err = launch_conv<8>(x, bias, y, wprep, ws, counters, p, map, use_tma, relu, s); break;
    case 16: err = launch_conv<16>(x, bias, y, wprep, ws, counters, p, map, use_tma, relu, s); break;
    case 32: err = launch_conv<32>(x, bias, y, wprep, ws, counters, p, map, use_tma, relu, s); break;
    case 64: err = launch_conv<64>(x, bias, y, wprep, ws, counters, p, map, use_tma, relu, s); break;
    case 128: err = launch_conv<128>(x, bias, y, wprep, ws, counters, p, map, use_tma, relu, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// One call of a conv on `stream`: the W' prologue (which also zeroes the
// split-K counters), then the conv, y = sum + bias. `scratch` holds
// p.scratch_floats floats (the wrapper's torch.empty): W', the split-K
// partials, then the counters. Returns a cudaError_t as an int (0: launched).
inline int run(const float* x, const float* w, const float* bias, float* y, float* scratch, const Plan& p,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(p) || scratch == nullptr || ((uintptr_t)scratch & 15)) return (int)cudaErrorInvalidValue;
  if ((long long)p.batch * p.lout * p.cout == 0) return 0;
  float* ws = scratch + p.wprep_floats;
  int* counters = reinterpret_cast<int*>(ws + p.ws_floats);
  err = launch_prep(w, scratch, counters, p, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return conv(x, scratch, bias, y, ws, counters, p, /*relu=*/0, device, stream);
}

}  // namespace igemm_tf32x3
