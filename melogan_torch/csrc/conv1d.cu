// Strided 1-D convolution, torch Conv1d geometry, channels last: a thin
// entry point over the implicit-GEMM cores, igemm_tf32x3.cuh (the f32 mode,
// 3xTF32) and igemm_bf16.cuh (the one-pass bf16 mode).
//
// Replaces: melogan_tpu/ops/pallas/conv1d.py::_conv1d_kernel (reached through
// _pallas_conv1d_fwd_impl / pallas_conv1d). That kernel splits the padded
// input into `stride` parity streams outside the kernel, because Mosaic has no
// strided loads, and then runs one contiguous-slice matmul per tap. The core
// stages the input rows a tile needs straight from the (B, L, Cin) tensor and
// reads row stride*t + k - p of them for tap k, so no streams are built.
//
// Layout: x (B, L, Cin) f32, w HIO (K, Cin, Cout) f32 (torch Conv1d weight
// (Cout, Cin, K) permuted to (K, Cin, Cout)), optional bias (Cout,),
// y (B, Lout, Cout) with Lout = (L + 2p - K) / s + 1. The plan
// (ops/igemm.py::conv1d_plan: a Tf32x3Plan, with bf16=True a Bf16Plan) is one class whose
// offset q is tap q; this file only checks that it is one of a plain conv.

#include "igemm_bf16.cuh"
#include "igemm_tf32x3.cuh"

// A plan of a plain conv: one class whose offset q is tap q.
template <class Plan>
static bool is_conv1d(const Plan& p) {
  return p.classes == 1 && p.sigma == p.stride && p.q == p.k;
}

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int; the Python wrapper raises if it is not 0.
// bf16 == 0: 3xTF32 on the core of igemm_tf32x3.cuh, `plan` an
// igemm_tf32x3::Plan, `scratch` the plan's scratch_floats floats (W' split
// once, split-K partials and counters).
// bf16 != 0: the one-pass bf16 core of igemm_bf16.cuh (x and w rounded to
// bf16 once, f32 sums), `plan` an igemm_bf16::Plan.
extern "C" int melogan_conv1d(const float* x, const float* w, const float* bias, float* y,
                              const void* plan, float* scratch, int device, void* stream, int bf16) {
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  if (bf16) {
    const auto& p = *static_cast<const igemm_bf16::Plan*>(plan);
    return is_conv1d(p) ? igemm_bf16::run(x, w, bias, y, p, device, stream)
                        : (int)cudaErrorInvalidValue;
  }
  const auto& p = *static_cast<const igemm_tf32x3::Plan*>(plan);
  return is_conv1d(p) ? igemm_tf32x3::run(x, w, bias, y, scratch, p, device, stream)
                      : (int)cudaErrorInvalidValue;
}
