// Transposed 1-D convolution, torch ConvTranspose1d geometry, channels last:
// a thin entry point over the implicit-GEMM core in igemm.cuh.
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
// Lout = (L-1)*s - 2p + K + op. The plan (ops/igemm.py::convt_plan) carries
// the tap table of every class; this file only checks that it is one of a
// transposed conv (input stride 1, one class per output parity).

#include "igemm.cuh"

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int; the Python wrapper raises if it is not 0.
extern "C" int melogan_convt1d(const float* x, const float* w, const float* bias, float* y,
                               const igemm::Plan* plan, int device, void* stream) {
  if (plan == nullptr || plan->sigma != 1 || plan->classes != plan->stride) {
    return (int)cudaErrorInvalidValue;
  }
  return igemm::run(x, w, bias, y, *plan, /*relu=*/0, device, stream);
}
