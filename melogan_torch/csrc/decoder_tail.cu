// Generator-decoder tail: three k5/s2/p2/op1 transposed convolutions, bias
// and ReLU after the first two, channels last: three launches of the f32
// conv core of igemm_tf32x3.cuh (3xTF32 on wgmma), the ReLU applied in the
// core's store, on W' planes prepared once per folded weights.
//
// Replaces: melogan_tpu/ops/pallas/decoder.py::_decoder_kernel (reached
// through fused_decoder_tail). The TPU kernel keeps the whole chain in VMEM
// as parity planes (1 -> 2 -> 4 -> 8 planes of length M), because Mosaic has
// no strided slices and each stage's HBM round trip was what it saved. Here
// each stage is one transposed conv of the core, whose store writes the
// interleaved rows 2t + r directly.
//
// Shapes on the main path: x (B, M=64, C0=256) -> h1 (B, 128, 128) ->
// h2 (B, 256, 64) -> y (B, 512, C3=4), f32. Weights HIO (5, Cin, Cout) with
// eval BatchNorm folded in ahead of the call; biases (Cout,). h1, h2 and the
// split-K workspace are scratch the caller allocates.
//
// Bound on an H100 SXM: 2*(5L-3)*Cin*Cout summed over the stages (the valid
// taps) = 31.9 MFLOP per sample at M = 64, 130.5 GFLOP at B = 4096: 0.79 ms at
// the 3xTF32 rate (495/3 = 165 TFLOP/s of f32 work on the tensor cores). The
// operations bound it: x and y are 73.7 KB a sample.
//
// Design:
// - Two entries. melogan_decoder_tail_prepare runs the core's prologue
//   (prep_w) for each stage: w gathered through the tap table and split into
//   TF32 planes, laid out as wgmma reads them, into one W' buffer the caller
//   holds with the folded weights (ops/decoder.py::TailStages), once per
//   W' layout (the plans' N tile and cw follow the batch). melogan_decoder_tail
//   then launches only the three convs on that W': a warm call does no
//   prologue, where the convs run it before every launch.
// - Why three launches and not one fused kernel on this card: fusing kept a
//   sample on one CTA (212 KB of shared memory, one SM per sample, 1 of 132
//   SMs busy at B = 1) and streamed the weights again for every sample. The
//   intermediates it saved cost little here: at B = 4096 h1 and h2 are
//   268 MB each, about 1.07 GB written and read again, at most 0.32 ms at
//   3.35 TB/s; at B = 1 they are 64 KB each and stay in L2. Each stage
//   instead spreads its work items over every SM (split-K parts where the
//   items alone cannot fill the card), on the tensor cores.
// - One stream, no host sync between launches: the split-K counters of all
//   three stages are zeroed by one memset before the first, and the stages
//   share one workspace of partial tiles (each runs after the last ends).

#include "igemm_tf32x3.cuh"

using igemm_tf32x3::Plan;

// Every plan is one of a transposed conv (input stride 1, one class per
// output parity) of the same batch, and the three chain (stage i + 1 reads
// stage i's output); checked before any launch.
static bool tail_plans_ok(const Plan* plans) {
  if (plans == nullptr) return false;
  for (int i = 0; i < 3; ++i) {
    const Plan& p = plans[i];
    if (!igemm_tf32x3::plan_ok(p) || p.sigma != 1 || p.classes != p.stride || p.batch != plans[0].batch)
      return false;
    if (i > 0 && (p.l != plans[i - 1].lout || p.cin != plans[i - 1].cout)) return false;
  }
  return true;
}

// Floats of W' before stage i's in the held buffer.
static long long wprep_offset(const Plan* plans, int i) {
  long long off = 0;
  for (int j = 0; j < i; ++j) off += plans[j].wprep_floats;
  return off;
}

// The W' planes of the three stages into `wprep` (the sum of the plans'
// wprep_floats, 16-byte aligned), one prologue launch each on `stream`.
// Returns the first cudaError_t as an int; the Python wrapper raises if it
// is not 0.
extern "C" int melogan_decoder_tail_prepare(const float* w1, const float* w2, const float* w3, float* wprep,
                                            const Plan plans[3], int device, void* stream) {
  if (!tail_plans_ok(plans)) return (int)cudaErrorInvalidValue;
  const float* w[3] = {w1, w2, w3};
  int err = 0;
  for (int i = 0; i < 3 && err == 0; ++i)
    err = igemm_tf32x3::prepare(w[i], wprep + wprep_offset(plans, i), plans[i], device, stream);
  return err;
}

// The three convs on `stream` (PyTorch's current stream) on W' that
// melogan_decoder_tail_prepare made for these plans' layouts. `ws` holds the
// largest of the plans' ws_floats, then one int counter per item of every
// split-K stage (plans[i].parts > 1), stage by stage. Returns the first
// cudaError_t as an int; the Python wrapper raises if it is not 0.
extern "C" int melogan_decoder_tail(const float* x, const float* wprep, const float* b1, const float* b2,
                                    const float* b3, float* h1, float* h2, float* y, float* ws,
                                    const Plan plans[3], int device, void* stream) {
  if (!tail_plans_ok(plans)) return (int)cudaErrorInvalidValue;
  int ws_floats = 0, counter_ints = 0;
  for (int i = 0; i < 3; ++i) {
    ws_floats = plans[i].ws_floats > ws_floats ? plans[i].ws_floats : ws_floats;
    counter_ints += plans[i].parts > 1 ? plans[i].items : 0;
  }
  int* counters = ws != nullptr ? reinterpret_cast<int*>(ws + ws_floats) : nullptr;
  if (counter_ints > 0) {
    if (counters == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const cudaError_t m = cudaMemsetAsync(counters, 0, sizeof(int) * counter_ints, (cudaStream_t)stream);
    if (m != cudaSuccess) return (int)m;
  }
  const float* in[3] = {x, h1, h2};
  float* out[3] = {h1, h2, y};
  const float* bias[3] = {b1, b2, b3};
  int err = 0;
  for (int i = 0; i < 3 && err == 0; ++i) {
    err = igemm_tf32x3::conv(in[i], wprep + wprep_offset(plans, i), bias[i], out[i], ws, counters, plans[i],
                             /*relu=*/i < 2, device, stream);
    if (plans[i].parts > 1) counters += plans[i].items;
  }
  return err;
}
