"""SHA-256 digests of the 3xTF32 kernels' outputs at ``chip_smoke.py``'s
``kernels`` shapes, to hold two trees' f32 kernels bit for bit equal.

    python -m melogan_torch.kernel_digests

Runs ``decoder_tail`` (batch 1 and 4096 at M = 64, 2048 at M = 128),
``convt1d`` (the decoder's layers at batch 1, 32 and 4096), ``conv1d`` (the
ED's layers and the VAE encoder's first at batch 32 and 1024) and both
input-gradient routes at batch 32, all in the f32 mode, on inputs drawn on
the card from one seed, and prints one JSON object a launch (kernel, shape,
digest of the output's bytes) and last the digest of all of them. It calls
only the wrappers' f32 signatures, so the same file runs in a checkout from
before the bf16 core (copy it into that tree's ``melogan_torch/``). Needs
CUDA.
"""
from __future__ import annotations

import hashlib
import json

import torch

DECODER = [(64, 256, 128), (128, 128, 64), (256, 64, 4)]
CONV1D = [(512, 4, 64, 5, 1, 2), (512, 64, 128, 3, 1, 1), (512, 128, 256, 3, 1, 1),
          (512, 256, 256, 3, 1, 1), (512, 4, 32, 5, 2, 2)]


def main() -> None:
    from melogan_torch.ops.conv1d import conv1d_cuda
    from melogan_torch.ops.convt import convt1d_cuda
    from melogan_torch.ops.decoder import fused_decoder_tail

    if not torch.cuda.is_available():
        raise SystemExit("kernel_digests needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    whole = hashlib.sha256()

    def emit(kernel, shape, out):
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.contiguous().cpu().numpy().tobytes()).hexdigest()
        whole.update(digest.encode())
        print(json.dumps({"kernel": kernel, "shape": shape, "sha256": digest}), flush=True)

    for b, m in ((1, 64), (4096, 64), (2048, 128)):
        widths = (256, 128, 64, 4)
        x = rand(b, m, widths[0])
        stages = [(rand(5, cin, cout, scale=(5 * cin) ** -0.5), rand(cout, scale=0.1))
                  for cin, cout in zip(widths[:-1], widths[1:])]
        emit("decoder_tail", [b, m], fused_decoder_tail(x, stages))
    for b in (1, 32, 4096):
        for l, cin, cout in DECODER:
            x, w, bias = rand(b, l, cin), rand(5, cin, cout, scale=(5 * cin) ** -0.5), rand(cout, scale=0.1)
            emit("convt1d", [b, l, cin, cout], convt1d_cuda(x, w, bias, 2, 2, 1))
    for b in (32, 1024):
        for l, cin, cout, k, s, p in CONV1D:
            x, w, bias = rand(b, l, cin), rand(k, cin, cout, scale=(k * cin) ** -0.5), rand(cout, scale=0.1)
            emit("conv1d", [b, l, cin, cout, k, s, p], conv1d_cuda(x, w, bias, s, p))
    # the input gradients at batch 32: conv1d's is convt1d on (g, wᵀ), convT's conv1d
    for l, cin, cout, k, s, p in CONV1D[:4]:
        g, wt = rand(32, (l + 2 * p - k) // s + 1, cout), rand(k, cout, cin, scale=(k * cin) ** -0.5)
        emit("convt1d", [32, "dx", l, cin, cout], convt1d_cuda(g, wt, None, s, p, (l + 2 * p - k) % s))
    for l, cin, cout in DECODER:
        g, wt = rand(32, 2 * l, cout), rand(5, cout, cin, scale=(5 * cin) ** -0.5)
        emit("conv1d", [32, "dx", l, cin, cout], conv1d_cuda(g, wt, None, 2, 2))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "all_sha256": whole.hexdigest()}), flush=True)


if __name__ == "__main__":
    main()
