"""SHA-256 digests of the kernels' outputs at ``chip_smoke.py``'s shapes, to
hold two trees' kernels bit for bit.

    python -m melogan_torch.kernel_digests

What holds now, and what the output lets one check (copy this file into a
parent tree's ``melogan_torch/``, a ``git archive`` under ``build/``, and run
it from both roots in one call):

- the f32 convs (``csrc/igemm_tf32x3.cuh``, at the ``kernels`` shapes) and
  the one-pass bf16 mode of ``convt1d`` and ``conv1d``
  (``csrc/igemm_bf16.cuh``, at the ``kernels_bf16`` shapes: the decoder's
  layers at batch 1, 32 and 4096, the ED's at 32, 64 and 1024, the VAE's at
  32 and 256, both input-gradient routes at 32) are bit-identical to the
  parent's: ``unchanged_sha256``, one digest over all of them, is the same
  in both trees;
- ``decoder_tail`` (batch 1 and 4096 at M = 64, 2048 at M = 128) runs on
  the f32 core of ``csrc/igemm_tf32x3.cuh`` now, whose sums run in another
  order than the parent's ``mma.sync`` core: its digest
  (``decoder_tail_sha256``) differs between the trees;
- every f32 launch (convs and tail) repeats bit for bit within a tree
  (``f32_repeats_bit_for_bit``).

Inputs are drawn on the card from one seed; one JSON object a launch
(kernel, mode, shape, digest), then the summary. It calls only the
wrappers' public signatures. Needs CUDA.
"""
from __future__ import annotations

import hashlib
import json

import torch

DECODER = [(64, 256, 128), (128, 128, 64), (256, 64, 4)]
ED = [(512, 4, 64, 5, 1, 2), (512, 64, 128, 3, 1, 1), (512, 128, 256, 3, 1, 1), (512, 256, 256, 3, 1, 1)]
VAE_ENCODER = [(512, 4, 32, 5, 2, 2), (256, 32, 64, 5, 2, 2), (128, 64, 128, 5, 2, 2)]
VAE_DECODER = [(64, 128, 64), (128, 64, 32), (256, 32, 4)]
CONV1D = ED + VAE_ENCODER[:1]
GROUP = {"bf16": "unchanged", "f32": "unchanged"}


def main() -> None:
    from melogan_torch.ops.conv1d import conv1d_cuda
    from melogan_torch.ops.convt import convt1d_cuda
    from melogan_torch.ops.decoder import fused_decoder_tail

    if not torch.cuda.is_available():
        raise SystemExit("kernel_digests needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    digests = {"unchanged": hashlib.sha256(), "decoder_tail": hashlib.sha256()}
    repeats = []

    def emit(kernel, mode, shape, run, group):
        """One launch's digest into ``group``: "unchanged" (the parent's
        bits) or "decoder_tail" (on a new core); an f32 launch must repeat."""
        out = run()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.contiguous().cpu().numpy().tobytes()).hexdigest()
        if mode == "f32":
            repeats.append(bool(torch.equal(out, run())))
        digests[group].update(digest.encode())
        print(json.dumps({"kernel": kernel, "mode": mode, "shape": shape, "sha256": digest}), flush=True)

    for b, m in ((1, 64), (4096, 64), (2048, 128)):
        widths = (256, 128, 64, 4)
        x = rand(b, m, widths[0])
        stages = [(rand(5, cin, cout, scale=(5 * cin) ** -0.5), rand(cout, scale=0.1))
                  for cin, cout in zip(widths[:-1], widths[1:])]
        emit("decoder_tail", "f32", [b, m], lambda: fused_decoder_tail(x, stages), "decoder_tail")

    def convt(b, l, cin, cout, mode, k=5, s=2, p=2, op=1, bias=True):
        x, w = rand(b, l, cin), rand(k, cin, cout, scale=(k * cin) ** -0.5)
        bb = rand(cout, scale=0.1) if bias else None
        emit("convt1d", mode, [b, l, cin, cout, k, s, p, op],
             lambda: convt1d_cuda(x, w, bb, s, p, op, bf16=mode == "bf16"), GROUP[mode])

    def conv(b, l, cin, cout, k, s, p, mode, bias=True):
        x, w = rand(b, l, cin), rand(k, cin, cout, scale=(k * cin) ** -0.5)
        bb = rand(cout, scale=0.1) if bias else None
        emit("conv1d", mode, [b, l, cin, cout, k, s, p],
             lambda: conv1d_cuda(x, w, bb, s, p, bf16=mode == "bf16"), GROUP[mode])

    for mode in ("bf16", "f32"):
        for b in (1, 32, 4096):
            for l, cin, cout in DECODER:
                convt(b, l, cin, cout, mode)
        for b in ((32, 64, 1024) if mode == "bf16" else (32, 1024)):
            for shape in (ED if mode == "bf16" else CONV1D):
                conv(b, *shape, mode)
        if mode == "bf16":
            for b in (32, 256):
                for shape in VAE_ENCODER:
                    conv(b, *shape, mode)
                for l, cin, cout in VAE_DECODER:
                    convt(b, l, cin, cout, mode)
        # the input gradients at batch 32: conv1d's is convt1d on (g, wᵀ), convT's conv1d
        for l, cin, cout, k, s, p in ED:
            convt(32, (l + 2 * p - k) // s + 1, cout, cin, mode, k, s, p, (l + 2 * p - k) % s, bias=False)
        for l, cin, cout in DECODER:
            conv(32, 2 * l, cout, cin, 5, 2, 2, mode, bias=False)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "unchanged_sha256": digests["unchanged"].hexdigest(),
                      "decoder_tail_sha256": digests["decoder_tail"].hexdigest(),
                      "f32_repeats_bit_for_bit": all(repeats)}), flush=True)


if __name__ == "__main__":
    main()
