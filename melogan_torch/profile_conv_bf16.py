"""The conv kernels' cores on the GPU: the one-pass bf16 core
(``csrc/igemm_bf16.cuh``, ``--mode bf16``, the default) or the 3xTF32 core
of the f32 mode (``--mode f32``).

    python -m melogan_torch.profile_conv_bf16 [--mode bf16|f32] [--part times|limits|ablate|all] [--repeats 20]

``--mode bf16``:

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

``--mode f32``: the same three parts for the f32 mode, whose yardstick is
``F.conv1d`` / ``F.conv_transpose1d`` on f32 tensors with TF32 off and whose
bound takes the operations at 3xTF32 (165 TFLOP/s):

1. ``times``: every f32 shape of ``chip_smoke.py``'s ``kernels``,
   ``kernels_ed``, ``kernels_vae``, ``backward_route`` and ``kernels_tp``
   phases (the input gradients as the other conv's launch on (g, wᵀ)); up
   to batch 64 also the device time of the kernels a call launches, the
   wrapper's and cuDNN's (``torch.profiler``), where the host sets the pace.
2. ``limits``: the decoder's layers at batch 4096 and the ED's at 1024 with
   the plan's N tile, cw and ring stages varied (the core of
   ``csrc/igemm_tf32x3.cuh`` only).
3. ``ablate``: ``conv1d`` at the ED's three widest layers (batch 1024) and
   ``convt1d`` at the decoder's (batch 4096) on patched copies of the f32
   core (``csrc/igemm_tf32x3.cuh``): without the products, without the
   per-chunk copies of x, of w or both, the copies alone, without the split
   into TF32 halves, without the W' prologue, and without the fold.

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
from melogan_torch.utils.flops import PEAK_3XTF32_FLOPS, PEAK_BF16_FLOPS, PEAK_HBM_BYTES

DECODER = [(64, 256, 128), (128, 128, 64), (256, 64, 4)]  # (L, Cin, Cout), k5 s2 p2 op1
ED = [(512, 4, 64, 5, 1, 2), (512, 64, 128, 3, 1, 1), (512, 128, 256, 3, 1, 1),
      (512, 256, 256, 3, 1, 1)]  # (L, Cin, Cout, K, s, p)
VAE_ENCODER = [(512, 4, 32, 5, 2, 2), (256, 32, 64, 5, 2, 2), (128, 64, 128, 5, 2, 2)]
VAE_DECODER = [(64, 128, 64), (128, 64, 32), (256, 32, 4)]
TP_CONVT = [(64, 128, 128)]  # the tensor-parallel shards at batch 32 (chip_smoke.py's kernels_tp)
TP_CONV1D = [(512, 128, 128, 3, 1, 1, "ed3_col"), (512, 128, 256, 3, 1, 1, "ed4_row")]


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

    def plan(self, bf16=True):
        b, l, cin = self.x.shape
        k, _, cout = self.w.shape
        if self.kind == "conv1d":
            return igemm.conv1d_plan(b, l, cin, cout, k, *self.geo, bf16=bf16)
        return igemm.convt_plan(b, l, cin, cout, k, *self.geo, bf16=bf16)

    def run(self, bf16=True):
        if self.kind == "conv1d":
            return conv1d_ops.conv1d_cuda(self.x, self.w, self.bias, *self.geo, bf16=bf16)
        return convt_ops.convt1d_cuda(self.x, self.w, self.bias, *self.geo, bf16=bf16)

    def launch(self, fn, plan, y, bf16):
        """``fn`` (a library's ``melogan_conv1d`` / ``melogan_convt1d``) with
        ``plan`` in place of the wrapper's own (no launch count: a
        measurement, not the main path). A plan with scratch (the f32
        core's) gets it here, once per plan; a tree from before that core
        passes none."""
        dev = self.x.device
        args = [self.x.data_ptr(), self.w.data_ptr(),
                self.bias.data_ptr() if self.bias is not None else None, y.data_ptr(),
                ctypes.byref(plan.c_struct())]
        if hasattr(plan, "scratch_floats"):
            scratch = self.__dict__.setdefault("_scratch", {})
            if plan not in scratch:
                scratch[plan] = torch.zeros(max(plan.scratch_floats, 1), device=dev)
            args.append(scratch[plan].data_ptr())
        err = fn(*args, dev.index, torch.cuda.current_stream(dev).cuda_stream, int(bf16))
        if err:
            raise RuntimeError(f"{self.kind} {self.name}: CUDA error {err} with {plan}")
        return y

    def run_plan(self, plan, y, bf16=True):
        lib = conv1d_ops._lib() if self.kind == "conv1d" else convt_ops._lib()
        return self.launch(lib.melogan_conv1d if self.kind == "conv1d" else lib.melogan_convt1d, plan, y, bf16)

    def plain(self, bf16=True):
        if self.kind == "conv1d":
            return conv1d_ops.conv1d_plain(self.x, self.w, self.bias, *self.geo, bf16=bf16)
        return convt_ops.convt1d_plain(self.x, self.w, self.bias, *self.geo, bf16=bf16)

    def library(self, bf16=True):
        """cuDNN on bf16 tensors (``bf16``) or on f32 ones (TF32 off),
        channels first, made once."""
        key = f"_lib_args_{bf16}"
        if not hasattr(self, key):
            cast = (lambda t: t.bfloat16()) if bf16 else (lambda t: t)
            xn = cast(self.x.transpose(1, 2).contiguous())
            perm = (2, 1, 0) if self.kind == "conv1d" else (1, 2, 0)
            wt = cast(self.w.permute(*perm).contiguous())
            bb = None if self.bias is None else cast(self.bias)
            setattr(self, key, (xn, wt, bb))
        xn, wt, bb = getattr(self, key)
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


def bound(flops: int, nbytes: int, peak: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
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


def make_layers(gen, b_dec=(1, 32, 4096), b_ed=(32, 64, 1024), b_vae=(32, 256), grads=True, f32=False):
    """(batch, Layer) of every shape a part runs; ``f32`` adds the f32
    mode's other shapes: the VAE encoder's first layer at the ED's
    batches (``kernels``), the ED's input gradients at 64
    (``kernels_ed``), the VAE's at 32 (``kernels_vae``) and the tensor-
    parallel shards with their input gradients at 32 (``kernels_tp``)."""
    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    def conv(b, name, l, cin, cout, k, s, p):
        return (b, Layer("conv1d", name, rand(b, l, cin), rand(k, cin, cout, scale=(k * cin) ** -0.5),
                         rand(cout, scale=0.1), (s, p)))

    def convt(b, name, l, cin, cout):
        return (b, Layer("convt1d", name, rand(b, l, cin), rand(5, cin, cout, scale=(5 * cin) ** -0.5),
                         rand(cout, scale=0.1), (2, 2, 1)))

    def dx_of_conv(b, name, l, cin, cout, k, s, p):  # convt1d on (g, wᵀ)
        return (b, Layer("convt1d", name, rand(b, (l + 2 * p - k) // s + 1, cout),
                         rand(k, cout, cin, scale=(k * cin) ** -0.5), None, (s, p, (l + 2 * p - k) % s)))

    def dx_of_convt(b, name, l, cin, cout):  # conv1d on (g, wᵀ)
        return (b, Layer("conv1d", name, rand(b, 2 * l, cout), rand(5, cout, cin, scale=(5 * cin) ** -0.5),
                         None, (2, 2)))

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
    if f32:
        for b in b_ed:
            if b != 64:
                layers.append(conv(b, "vae1", *VAE_ENCODER[0]))
        for i, (l, cin, cout, k, s, p) in enumerate(ED[1:]):
            layers.append(dx_of_conv(64, f"dx_ed{i + 2}", l, cin, cout, k, s, p))
        for i, shape in enumerate(VAE_ENCODER):
            layers.append(dx_of_conv(32, f"dx_vae_enc{i + 1}", *shape))
        for i, shape in enumerate(VAE_DECODER):
            layers.append(dx_of_convt(32, f"dx_vae_dec{i + 1}", *shape))
        for shape in TP_CONVT:
            layers.append(convt(32, "tp_dec1_row", *shape))
        for l, cin, cout, k, s, p, name in TP_CONV1D:
            layers.append(conv(32, f"tp_{name}", l, cin, cout, k, s, p))
            layers.append(dx_of_conv(32, f"dx_tp_{name}", l, cin, cout, k, s, p))
        for shape in TP_CONVT:
            layers.append(dx_of_convt(32, "dx_tp_dec1_row", *shape))
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


def _x_path(layer, plan):
    """Which copies fed x: "tma" or "cp.async" (the f32 core's rule, read
    from this tree's ``ops/igemm.py``), or None in a tree from before it."""
    rule = getattr(igemm, "tf32_x_path", None)
    return rule(plan, layer.x.data_ptr()) if rule and hasattr(plan, "scratch_floats") else None


def _device_ms(fn, calls: int = 10) -> float:
    """Device time of the kernels one ``fn()`` launches (a ``torch.profiler``
    trace of ``calls`` calls): at small shapes the events' time is the
    host's, which launches slower than the card runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if str(ev.device_type).endswith("CUDA") and not getattr(ev, "is_user_annotation", False))
    return us / calls / 1e3


def times_f32(gen, repeats: int):
    """Every f32 shape: the kernel against the plain version (err of scale),
    a second launch bit for bit the first, timed beside cuDNN on f32
    tensors (TF32 off), bound at 3xTF32."""
    out = []
    for b, layer in make_layers(gen, f32=True):
        y = layer.run(False)
        again = layer.run(False)
        ref = layer.plain(False)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        plan = layer.plan(False)
        reps = repeats if b > 64 else 5 * repeats
        rec = {"part": "times", "mode": "f32", "kernel": layer.kind, "layer": layer.name, "batch": b,
               "shape": layer.shape, "err_of_scale": float((y - ref).abs().max()) / scale,
               "bit_equal_repeat": bool(torch.equal(y, again)),
               "ms": _event_ms(lambda: layer.run(False), reps),
               "library_ms": _event_ms(lambda: layer.library(False), reps),
               **bound(layer.flops(), layer.nbytes(y), PEAK_3XTF32_FLOPS),
               "plan": {k: getattr(plan, k) for k in ("tile_m", "tile_n", "cw", "stages", "parts", "grid",
                                                       "smem_bytes") if hasattr(plan, k)},
               "x_path": _x_path(layer, plan)}
        if b <= 64:  # where the host may set the pace: the card's own time too
            rec["device_ms"] = _device_ms(lambda: layer.run(False))
            rec["library_device_ms"] = _device_ms(lambda: layer.library(False))
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


def limits_f32(gen, repeats: int):
    """The f32 core's plan varied at the largest shapes: N tile, cw and ring
    stages, each that fits."""
    out = []
    layers = make_layers(gen, b_dec=(4096,), b_ed=(1024,), b_vae=(), grads=False)
    for b, layer in layers:
        base = layer.plan(False)
        if not hasattr(base, "scratch_floats"):
            raise SystemExit("--mode f32 --part limits needs the core of csrc/igemm_tf32x3.cuh")
        ref = layer.plain(False)
        scale = float(ref.abs().max())
        for v in igemm.tf32_variants(base):
            y = torch.empty_like(ref)
            layer.run_plan(v, y, False)
            torch.cuda.synchronize()
            rec = {"part": "limits", "mode": "f32", "kernel": layer.kind, "layer": layer.name, "batch": b,
                   "tile": [v.tile_m, v.tile_n], "cw": v.cw, "stages": v.stages, "chunks": v.chunks,
                   "parts": v.parts, "smem": v.smem_bytes, "default": v == base,
                   "err_of_scale": float((y - ref).abs().max()) / scale,
                   "ms": _event_ms(lambda: layer.run_plan(v, y, False), repeats)}
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


_T_PRODUCTS = "          for (int h = 0; h < 2; ++h) {"  # the wgmmas of a pair (the loop still prepares)
_T_SPLIT_IM2COL = "          for (int e = wtid; e < 2 * ksteps * kWgRows; e += 128) {"
_T_SPLIT_HALO = "            for (int e = wtid; e < (need_rows << g_shift); e += 128) {"
_T_W = "        const uint32_t w_bytes = 2u * w.depth * TN * 4;"
_T_X = "        const int x_windows = kConsumers;"
_T_FIRST_TWO = "c < w.c_lo + 2"  # a unit's first two chunks: their data stays for the rest
_T_PROLOGUE = "  prep_w<<<prep_blocks, 256, 0, stream>>>(w, wprep, counters, p);\n"
ABLATIONS_TF32X3 = {  # text patches of csrc/igemm_tf32x3.cuh
    "full": [],
    "no_products": [(_T_PRODUCTS, _T_PRODUCTS.replace("h < 2", "h < 0"))],
    "no_split": [(_T_SPLIT_IM2COL, _T_SPLIT_IM2COL.replace("e < 2 * ksteps * kWgRows", "e < 0")),
                 (_T_SPLIT_HALO, _T_SPLIT_HALO.replace("e < (need_rows << g_shift)", "e < 0"))],
    "no_x_copies": [(_T_X, _T_X.replace("= kConsumers", f"= {_T_FIRST_TWO} ? kConsumers : 0"))],
    "no_w_copies": [(_T_W, _T_W.replace("= 2u", f"= !({_T_FIRST_TWO}) ? 0u : 2u"))],
    "no_copies": [(_T_X, _T_X.replace("= kConsumers", f"= {_T_FIRST_TWO} ? kConsumers : 0")),
                  (_T_W, _T_W.replace("= 2u", f"= !({_T_FIRST_TWO}) ? 0u : 2u"))],
    "copies_only": [(_T_PRODUCTS, _T_PRODUCTS.replace("h < 2", "h < 0")),
                    (_T_SPLIT_IM2COL, _T_SPLIT_IM2COL.replace("e < 2 * ksteps * kWgRows", "e < 0")),
                    (_T_SPLIT_HALO, _T_SPLIT_HALO.replace("e < (need_rows << g_shift)", "e < 0"))],
    "no_prologue": [(_T_PROLOGUE, "")],
    "no_fold": [("    for (int i = 0; i < R; ++i) acc[i] = 0.f;", "    for (int i = 0; i < R; ++i) acc[i] = part[i] = 0.f;"),
                ("Wgmma<TN>::mma(part, as, bb, h);", "Wgmma<TN>::mma(part, as, bb, 1);"),
                ("for (int i = 0; i < R; ++i) acc[i] += part[i];", "for (int i = 0; i < R; ++i) acc[i] = part[i];")],
}


def ablate(gen, repeats: int, bf16: bool = True):
    """Time patched copies of a core: the bf16 one on ``conv1d`` at the ED's
    layers 2–4 (batch 1024), or with ``bf16`` False the f32 one
    (``igemm_tf32x3.cuh``) there and on ``convt1d`` at the decoder's layers
    (batch 4096)."""
    header, ablations = ("igemm_bf16.cuh", ABLATIONS) if bf16 else ("igemm_tf32x3.cuh", ABLATIONS_TF32X3)
    root = _build.BUILD_DIR.parent / ("ablate" if bf16 else "ablate_f32")
    kinds = ("conv1d",) if bf16 else ("conv1d", "convt1d")
    nvcc = _build.find_nvcc()
    procs = {}
    for name, patches in ablations.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f in [*(_build.CSRC / f"{k}.cu" for k in kinds), *_build.CSRC.glob("*.cuh")]:
            shutil.copy(f, d)
        text = (_build.CSRC / header).read_text()
        for a, b in patches:
            if a not in text:
                raise RuntimeError(f"ablation {name}: the core no longer has {a!r}")
            text = text.replace(a, b)
        (d / header).write_text(text)
        for k in kinds:
            procs[name, k] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(d / f"lib_{k}.so"), str(d / f"{k}.cu")],
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    libs = {}
    for (name, k), proc in procs.items():
        if proc.wait():
            raise RuntimeError(f"ablation {name}: nvcc failed on {k}.cu")
        libs[name, k] = ctypes.CDLL(os.fspath(root / name / f"lib_{k}.so"))
    layers = make_layers(gen, b_dec=(), b_ed=(1024,), b_vae=(), grads=False)[1:]
    if not bf16:
        layers += make_layers(gen, b_dec=(4096,), b_ed=(), b_vae=(), grads=False)
    out = []
    for b, layer in layers:
        plan = layer.plan(bf16)
        ref = layer.plain(bf16)
        scale = float(ref.abs().max())
        y = torch.empty_like(ref)
        rec = {"part": "ablate", "mode": "bf16" if bf16 else "f32", "core": header, "kernel": layer.kind,
               "layer": layer.name, "batch": b, "tile": [plan.tile_m, plan.tile_n], "cw": plan.cw,
               "stages": getattr(plan, "stages", None)}
        for name in ablations:
            lib = libs[name, layer.kind]
            fn = getattr(lib, f"melogan_{layer.kind}")
            n_ptr = 6 if hasattr(plan, "scratch_floats") else 5
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]

            def run(fn=fn):
                layer.launch(fn, plan, y, bf16)
            rec[f"{name}_ms"] = _event_ms(run, repeats)
            if name in ("full", "no_fold", "no_split"):
                run()
                torch.cuda.synchronize()
                rec[f"{name}_err_of_scale"] = float((y - ref).abs().max()) / scale
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--part", choices=("times", "limits", "ablate", "all"), default="all")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_conv_bf16 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "mode": args.mode}), flush=True)
    bf16 = args.mode == "bf16"
    if args.part in ("times", "all"):
        (times if bf16 else times_f32)(gen, args.repeats)
    if args.part in ("limits", "all"):
        (limits if bf16 else limits_f32)(gen, args.repeats)
    if args.part in ("ablate", "all"):
        ablate(gen, args.repeats, bf16)


if __name__ == "__main__":
    main()
