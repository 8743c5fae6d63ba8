// Generator-decoder tail: three k5/s2/p2/op1 transposed convolutions, bias
// and ReLU after the first two, channels last: three launches of the
// implicit-GEMM core in igemm.cuh, the ReLU applied in the core's store.
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
// eval BatchNorm folded in ahead of the call, read in place as convt1d reads
// them (no flip, no copy); biases (Cout,). h1 and h2 are scratch the caller
// allocates.
//
// Bound on an H100 SXM: 2*(5L-3)*Cin*Cout summed over the stages (the valid
// taps) = 31.9 MFLOP per sample at M = 64, 130.5 GFLOP at B = 4096: 0.79 ms at
// the 3xTF32 rate (495/3 = 165 TFLOP/s of f32 work on the tensor cores). The
// operations bound it: x and y are 73.7 KB a sample.
//
// Why three launches and not one fused kernel on this card: fusing kept a
// sample on one CTA (212 KB of shared memory, one SM per sample, 1 of 132 SMs
// busy at B = 1), summed in IEEE f32 FMAs outside the tensor cores, and
// streamed the 824 KB of weights from L2 again for every sample. The
// intermediates it saved cost little here: at B = 4096 h1 and h2 are 268 MB
// each, about 1.07 GB written and read again, at most 0.32 ms at 3.35 TB/s;
// at B = 1 they are 64 KB each and stay in L2. Each stage instead spreads its
// (sample, row tile) x column tile grid over every SM, on the tensor cores.
// The launches go on one stream with no host sync between them.

#include "igemm.cuh"

// A plan of a transposed conv (input stride 1, one class per output parity).
static bool convt_plan_ok(const igemm::Plan& p) {
  return igemm::plan_ok(p) && p.sigma == 1 && p.classes == p.stride;
}

// plans[i] is stage i's plan (ops/igemm.py::convt_plan); each is checked,
// and the three must chain (stage i + 1 reads stage i's output), before any
// launch. Launches on `stream` (PyTorch's current stream) and returns the
// first cudaError_t as an int; the Python wrapper raises if it is not 0.
extern "C" int melogan_decoder_tail(const float* x, const float* w1, const float* b1,
                                    const float* w2, const float* b2, const float* w3,
                                    const float* b3, float* h1, float* h2, float* y,
                                    const igemm::Plan plans[3], int device, void* stream) {
  if (plans == nullptr) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    if (!convt_plan_ok(plans[i]) || plans[i].batch != plans[0].batch) return (int)cudaErrorInvalidValue;
    if (i > 0 && (plans[i].l != plans[i - 1].lout || plans[i].cin != plans[i - 1].cout)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  int err = igemm::run(x, w1, b1, h1, plans[0], /*relu=*/1, device, stream);
  if (err == 0) err = igemm::run(h1, w2, b2, h2, plans[1], /*relu=*/1, device, stream);
  if (err == 0) err = igemm::run(h2, w3, b3, y, plans[2], /*relu=*/0, device, stream);
  return err;
}
