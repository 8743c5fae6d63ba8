// Transposed 1-D convolution, torch ConvTranspose1d geometry, channels last:
// a thin entry point over the implicit-GEMM cores, igemm_tf32x3.cuh (the f32
// mode, 3xTF32) and igemm_bf16.cuh (the one-pass bf16 mode).
//
// Replaces: melogan_tpu/ops/pallas/conv1d.py::_convt_kernel (reached through
// _pallas_convt_fwd_impl / pallas_conv_transpose1d). That kernel computes the
// output as parity planes, out[s*t + r] = sum over _convt_taps of
// x[t + off] . w_flip[j], and interleaves them afterwards, because Mosaic has
// no strided stores. Here the parity classes are the column blocks of one
// GEMM, n = r*Cout + co, so one launch computes every class and the store
// writes the interleaved output row s*t + r directly (masked at Lout).
//
// Layout: x (B, L, Cin) f32, w HIO (K, Cin, Cout) f32 as stored by the JAX
// package, optional bias (Cout,), y (B, Lout, Cout) with
// Lout = (L-1)*s - 2p + K + op. The plan (ops/igemm.py::convt_plan: a Tf32x3Plan,
// with bf16=True a Bf16Plan) carries the tap table of every class; this file only checks that it is one of a
// transposed conv (input stride 1, one class per output parity).

#include "igemm_bf16.cuh"
#include "igemm_tf32x3.cuh"

// A plan of a transposed conv: input stride 1, one class per output parity.
template <class Plan>
static bool is_convt(const Plan& p) {
  return p.sigma == 1 && p.classes == p.stride;
}

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int; the Python wrapper raises if it is not 0.
// bf16 == 0: 3xTF32 on the core of igemm_tf32x3.cuh, `plan` an
// igemm_tf32x3::Plan, `scratch` the plan's scratch_floats floats (W' split
// once, split-K partials and counters).
// bf16 != 0: the one-pass bf16 core of igemm_bf16.cuh (x and w rounded to
// bf16 once, f32 sums), `plan` an igemm_bf16::Plan.
extern "C" int melogan_convt1d(const float* x, const float* w, const float* bias, float* y,
                               const void* plan, float* scratch, int device, void* stream, int bf16) {
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  if (bf16) {
    const auto& p = *static_cast<const igemm_bf16::Plan*>(plan);
    return is_convt(p) ? igemm_bf16::run(x, w, bias, y, p, device, stream)
                       : (int)cudaErrorInvalidValue;
  }
  const auto& p = *static_cast<const igemm_tf32x3::Plan*>(plan);
  return is_convt(p) ? igemm_tf32x3::run(x, w, bias, y, scratch, p, device, stream)
                     : (int)cudaErrorInvalidValue;
}
