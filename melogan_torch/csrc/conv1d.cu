// Strided 1-D convolution, torch Conv1d geometry, channels last: a thin
// entry point over the implicit-GEMM core in igemm.cuh.
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
// (ops/igemm.py::conv1d_plan) is one class whose offset q is tap q; this file
// only checks that it is one of a plain conv.

#include "igemm.cuh"

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int; the Python wrapper raises if it is not 0.
extern "C" int melogan_conv1d(const float* x, const float* w, const float* bias, float* y,
                              const igemm::Plan* plan, int device, void* stream) {
  if (plan == nullptr || plan->classes != 1 || plan->sigma != plan->stride ||
      plan->q != plan->k) {
    return (int)cudaErrorInvalidValue;
  }
  return igemm::run(x, w, bias, y, *plan, /*relu=*/0, device, stream);
}
