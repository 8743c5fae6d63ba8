"""The conv kernels' one-pass bf16 core (``csrc/igemm_bf16.cuh``) on the GPU.

    python -m melogan_torch.profile_conv_bf16 [--part times|limits|ablate|all] [--repeats 20]

1. ``times``: every layer that ``chip_smoke.py``'s ``kernels_bf16`` phase
   runs (the decoder's transposed convs at batch 1, 32 and 4096, the ED's
   convs at 32, 64 and 1024, the VAE's at 32 and 256, both input-gradient
   routes at 32), each timed with CUDA events in the bf16 mode, in the f32
   mode and as cuDNN on bf16 tensors (the yardstick: bf16 in and out, f32
   sums), with its error of scale against the plain version
   (``bf16=True``), a bit-for-bit repeat, and its bound: the f32 bytes the
   kernel must move (x, w, bias and y, each once, at 3.35 TB/s) against the
   operations at the dense bf16 rate (989.4 TFLOP/s).
2. ``limits``: at the two largest shapes (the decoder's layers at batch
   4096, the ED's at 1024) the same layers with the plan varied: the CTA
   tile (and with it the warp tile), cw (input channels a chunk) and the
   landing stages. Each line carries the plan's shared-memory bytes per
   multiply-add (fragments, and staging: the f32 landing written and read
   and the bf16 tile written) beside the time, to read whether the time
   follows the fragment bytes, cw or the warp tile.
3. ``ablate``: ``conv1d`` at the ED's three widest layers (batch 1024) on
   copies of the core with one phase taken out, built with ``nvcc`` under
   ``build/ablate/`` from patched copies of ``csrc/`` (their outputs are
   wrong; only their times are read): without the products
   (``no_products``), without the per-chunk copies of x (``no_x_copies``),
   of w (``no_w_copies``) or both (``no_copies``: the first chunks' data
   reused), without the rounding, or the copies alone (``copies_only``:
   no rounding, no products), and without the fold (one chain of sums,
   whose error of scale is printed beside the fold's).

Prints one JSON object a line; needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import shutil
import subprocess

import torch
import torch.nn.functional as F

from melogan_torch.ops import _build
from melogan_torch.ops import conv1d as conv1d_ops
from melogan_torch.ops import convt as convt_ops
from melogan_torch.ops import igemm
from melogan_torch.utils.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

DECODER = [(64, 256, 128), (128, 128, 64), (256, 64, 4)]  # (L, Cin, Cout), k5 s2 p2 op1
ED = [(512, 4, 64, 5, 1, 2), (512, 64, 128, 3, 1, 1), (512, 128, 256, 3, 1, 1),
      (512, 256, 256, 3, 1, 1)]  # (L, Cin, Cout, K, s, p)
VAE_ENCODER = [(512, 4, 32, 5, 2, 2), (256, 32, 64, 5, 2, 2), (128, 64, 128, 5, 2, 2)]
VAE_DECODER = [(64, 128, 64), (128, 64, 32), (256, 32, 4)]


def _event_ms(fn, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


@dataclasses.dataclass
class Layer:
    kind: str  # "conv1d" or "convt1d"
    name: str
    x: torch.Tensor
    w: torch.Tensor
    bias: torch.Tensor | None
    geo: tuple  # (s, p) or (s, p, op)

    @property
    def shape(self):
        return [*self.x.shape, self.w.shape[2], self.w.shape[0], *self.geo]

    def plan(self):
        b, l, cin = self.x.shape
        k, _, cout = self.w.shape
        if self.kind == "conv1d":
            return igemm.conv1d_plan(b, l, cin, cout, k, *self.geo, bf16=True)
        return igemm.convt_plan(b, l, cin, cout, k, *self.geo, bf16=True)

    def run(self, bf16=True):
        if self.kind == "conv1d":
            return conv1d_ops.conv1d_cuda(self.x, self.w, self.bias, *self.geo, bf16=bf16)
        return convt_ops.convt1d_cuda(self.x, self.w, self.bias, *self.geo, bf16=bf16)

    def run_plan(self, plan, y):
        """The bf16 core with ``plan`` in place of the wrapper's own (no
        launch count: a measurement, not the main path)."""
        lib = conv1d_ops._lib() if self.kind == "conv1d" else convt_ops._lib()
        fn = lib.melogan_conv1d if self.kind == "conv1d" else lib.melogan_convt1d
        dev = self.x.device
        err = fn(self.x.data_ptr(), self.w.data_ptr(),
                 self.bias.data_ptr() if self.bias is not None else None, y.data_ptr(),
                 ctypes.byref(plan.c_struct()), dev.index, torch.cuda.current_stream(dev).cuda_stream, 1)
        if err:
            raise RuntimeError(f"{self.kind} {self.name}: CUDA error {err} with {plan}")
        return y

    def plain(self):
        if self.kind == "conv1d":
            return conv1d_ops.conv1d_plain(self.x, self.w, self.bias, *self.geo, bf16=True)
        return convt_ops.convt1d_plain(self.x, self.w, self.bias, *self.geo, bf16=True)

    def library(self):
        """cuDNN on bf16 tensors, channels first, made once."""
        if not hasattr(self, "_lib_args"):
            xn = self.x.transpose(1, 2).contiguous().bfloat16()
            perm = (2, 1, 0) if self.kind == "conv1d" else (1, 2, 0)
            wt = self.w.permute(*perm).contiguous().bfloat16()
            bb = None if self.bias is None else self.bias.bfloat16()
            self._lib_args = (xn, wt, bb)
        xn, wt, bb = self._lib_args
        if self.kind == "conv1d":
            return F.conv1d(xn, wt, bb, *self.geo)
        return F.conv_transpose1d(xn, wt, bb, *self.geo)

    def flops(self) -> int:
        b, l, cin = self.x.shape
        k, _, cout = self.w.shape
        if self.kind == "conv1d":
            return conv1d_ops.conv1d_flops(b, l, cin, cout, k, *self.geo)
        return convt_ops.convt_flops(b, l, cin, cout, k, *self.geo)

    def nbytes(self, y) -> int:
        return 4 * (self.x.numel() + self.w.numel() + (0 if self.bias is None else self.bias.numel())
                    + y.numel())


def bound(flops: int, nbytes: int) -> dict:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def smem_bytes_per_mac(plan) -> dict:
    """Shared-memory traffic of the plan per multiply-add of its tile
    (structural zeros and padding included): ldmatrix fragments (2 bytes
    an element, A read by every warp column, B by every warp row), and
    staging (4 bytes written by cp.async, 4 read and 2 written by the
    rounding, for every landed element)."""
    wm, wn = plan.warp_m, min(plan.tile_n, 32)
    frag = 2 / wn + 2 / wm
    depth = plan.w_rows  # the plan's reduction rows a chunk
    staging = 10 * plan.land_floats / (plan.tile_m * plan.tile_n * depth)
    return {"warp_tile": [wm, wn], "frag_b_per_mac": frag, "staging_b_per_mac": staging,
            "smem_b_per_mac": frag + staging}


def make_layers(gen, b_dec=(1, 32, 4096), b_ed=(32, 64, 1024), b_vae=(32, 256), grads=True):
    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    layers = []
    for b in b_dec:
        for i, (l, cin, cout) in enumerate(DECODER):
            layers.append((b, Layer("convt1d", f"dec{i + 1}", rand(b, l, cin),
                                    rand(5, cin, cout, scale=(5 * cin) ** -0.5), rand(cout, scale=0.1),
                                    (2, 2, 1))))
    for b in b_ed:
        for i, (l, cin, cout, k, s, p) in enumerate(ED):
            layers.append((b, Layer("conv1d", f"ed{i + 1}", rand(b, l, cin),
                                    rand(k, cin, cout, scale=(k * cin) ** -0.5), rand(cout, scale=0.1),
                                    (s, p))))
    for b in b_vae:
        for i, (l, cin, cout, k, s, p) in enumerate(VAE_ENCODER):
            layers.append((b, Layer("conv1d", f"vae_enc{i + 1}", rand(b, l, cin),
                                    rand(k, cin, cout, scale=(k * cin) ** -0.5), rand(cout, scale=0.1),
                                    (s, p))))
        for i, (l, cin, cout) in enumerate(VAE_DECODER):
            layers.append((b, Layer("convt1d", f"vae_dec{i + 1}", rand(b, l, cin),
                                    rand(5, cin, cout, scale=(5 * cin) ** -0.5), rand(cout, scale=0.1),
                                    (2, 2, 1))))
    if grads:  # the input gradients at the training batch, on (g, wᵀ)
        for i, (l, cin, cout, k, s, p) in enumerate(ED):
            wt = rand(k, cout, cin, scale=(k * cin) ** -0.5)
            layers.append((32, Layer("convt1d", f"dx_ed{i + 1}", rand(32, (l + 2 * p - k) // s + 1, cout),
                                     wt, None, (s, p, (l + 2 * p - k) % s))))
        for i, (l, cin, cout) in enumerate(DECODER):
            wt = rand(5, cout, cin, scale=(5 * cin) ** -0.5)
            layers.append((32, Layer("conv1d", f"dx_dec{i + 1}", rand(32, 2 * l, cout), wt, None, (2, 2))))
    return layers


def times(gen, repeats: int):
    out = []
    for b, layer in make_layers(gen):
        y = layer.run()
        again = layer.run()
        ref = layer.plain()
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((y - ref).abs().max())
        reps = repeats if b > 64 else 5 * repeats
        rec = {"part": "times", "kernel": layer.kind, "layer": layer.name, "batch": b,
               "shape": layer.shape, "err_of_scale": err / scale, "bit_equal_repeat": bool(torch.equal(y, again)),
               "ms": _event_ms(layer.run, reps), "f32_ms": _event_ms(lambda: layer.run(False), reps),
               "library_ms": _event_ms(layer.library, reps), **bound(layer.flops(), layer.nbytes(y)),
               "plan": {"tile": [layer.plan().tile_m, layer.plan().tile_n], "cw": layer.plan().cw,
                        "stages": layer.plan().stages, "smem": layer.plan().smem_bytes}}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def _variants(plan):
    """The plan with its CTA tile, warp tile, cw and landing stages varied,
    each that fits one CTA's shared memory."""
    if plan.tile_n >= 64:
        tiles = [(128, 64, 64), (256, 64, 64), (128, 128, 64), (64, 64, 32), (128, 64, 32),
                 (256, 64, 32), (128, 128, 32)]
    else:
        tiles = [(plan.tile_m, plan.tile_n, plan.warp_m)]
    widths = [plan.cw] if plan.im2col else [c for c in (16, 32, 64) if c <= max(16, igemm._pow2(plan.cin))]
    seen = []
    for tm, tn, wm in tiles:
        for cw in widths:
            for stages in (1, 2):
                v = dataclasses.replace(plan, tile_m=tm, tile_n=tn, warp_m=wm, cw=cw, stages=stages)
                if stages == 2 and v.chunks < 2:
                    continue
                if v.smem_bytes <= igemm.SMEM_LIMIT and v not in seen:
                    seen.append(v)
    return seen


def limits(gen, repeats: int):
    out = []
    layers = make_layers(gen, b_dec=(4096,), b_ed=(1024,), b_vae=(), grads=False)
    for b, layer in layers:
        base = layer.plan()
        ref = layer.plain()
        scale = float(ref.abs().max())
        for v in _variants(base):
            y = torch.empty_like(ref)
            layer.run_plan(v, y)
            torch.cuda.synchronize()
            rec = {"part": "limits", "kernel": layer.kind, "layer": layer.name, "batch": b,
                   "tile": [v.tile_m, v.tile_n], "threads": v.threads, "cw": v.cw, "stages": v.stages, "chunks": v.chunks,
                   "smem": v.smem_bytes, "default": v == base,
                   "err_of_scale": float((y - ref).abs().max()) / scale,
                   "ms": _event_ms(lambda: layer.run_plan(v, y), repeats), **smem_bytes_per_mac(v)}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


_LOOP = "    load(buf, 0, f0);\n    for (int ks = 0; ks < ksteps; ks += 2) {"
_XCOPY = "    for (int rr = xr0; rr < p.a_rows; rr += xr_step) {\n      const int off"
_WCOPY = "    for (int kk = wr0; kk < ksteps * 16; kk += wr_step) {\n      const int ci"
_ROUND = "    round_in(st, c & 1);\n"
ABLATIONS = {  # text patches of csrc/igemm_bf16.cuh
    "full": [],
    "no_products": [(_LOOP, "    for (int ks = 0; ks < 0; ks += 2) {")],
    "no_x_copies": [(_XCOPY, _XCOPY.replace("rr < p.a_rows", "rr < (c < 2 ? p.a_rows : 0)"))],
    "no_w_copies": [(_WCOPY, _WCOPY.replace("kk < ksteps * 16", "kk < (c < 2 ? ksteps * 16 : 0)"))],
    "no_copies": [(_XCOPY, _XCOPY.replace("rr < p.a_rows", "rr < (c < 2 ? p.a_rows : 0)")),
                  (_WCOPY, _WCOPY.replace("kk < ksteps * 16", "kk < (c < 2 ? ksteps * 16 : 0)"))],
    "no_rounding": [(_ROUND, "")],
    "copies_only": [(_LOOP, "    for (int ks = 0; ks < 0; ks += 2) {"), (_ROUND, "")],
    "no_fold": [("      float part[kMT][kNT][4];\n", "      auto& part = acc;\n"),
                ("      step(f0, true, part);", "      step(f0, false, part);"),
                ("acc[i][j][e] += part[i][j][e];", "(void)0;")],
}


def ablate(gen, repeats: int):
    """Time ``conv1d`` in the bf16 mode on patched copies of the core."""
    root = _build.BUILD_DIR.parent / "ablate"
    nvcc = _build.find_nvcc()
    procs = {}
    for name, patches in ABLATIONS.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f in ("conv1d.cu", "igemm.cuh"):
            shutil.copy(_build.CSRC / f, d)
        text = (_build.CSRC / "igemm_bf16.cuh").read_text()
        for a, b in patches:
            if a not in text:
                raise RuntimeError(f"ablation {name}: the core no longer has {a!r}")
            text = text.replace(a, b)
        (d / "igemm_bf16.cuh").write_text(text)
        procs[name] = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "conv1d.cu")],
                                       stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        if proc.wait():
            raise RuntimeError(f"ablation {name}: nvcc failed")
        lib = ctypes.CDLL(os.fspath(root / name / "lib.so"))
        lib.melogan_conv1d.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    out = []
    for b, layer in make_layers(gen, b_dec=(), b_ed=(1024,), b_vae=(), grads=False)[1:]:
        plan = layer.plan()
        ref = layer.plain()
        scale = float(ref.abs().max())
        y = torch.empty_like(ref)
        rec = {"part": "ablate", "kernel": layer.kind, "layer": layer.name, "batch": b,
               "tile": [plan.tile_m, plan.tile_n], "cw": plan.cw, "stages": plan.stages}
        for name, lib in libs.items():
            def run(lib=lib):
                lib.melogan_conv1d(layer.x.data_ptr(), layer.w.data_ptr(), layer.bias.data_ptr(), y.data_ptr(),
                                   ctypes.byref(plan.c_struct()), layer.x.device.index,
                                   torch.cuda.current_stream().cuda_stream, 1)
            rec[f"{name}_ms"] = _event_ms(run, repeats)
            if name in ("full", "no_fold"):
                run()
                torch.cuda.synchronize()
                rec[f"{name}_err_of_scale"] = float((y - ref).abs().max()) / scale
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("times", "limits", "ablate", "all"), default="all")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_conv_bf16 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    if args.part in ("times", "all"):
        times(gen, args.repeats)
    if args.part in ("limits", "all"):
        limits(gen, args.repeats)
    if args.part in ("ablate", "all"):
        ablate(gen, args.repeats)


if __name__ == "__main__":
    main()
