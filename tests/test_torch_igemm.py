"""The geometry of the implicit-GEMM cores of the conv kernels and the
decoder tail (``ops/igemm.py``) on the CPU, without a card.

The CUDA cores compute
Y[b, t, n] = bias[n mod Cout] + Σ_q Σ_ci X[b, σ·t + o_min + q, ci] · W'[q, ci, n]
from a plan made here. These tests hold the plan's tap table against the JAX
package's ``_convt_taps``, execute the plan with torch matmuls (the cores'
algebra: gather rows by σ·t + o_q, multiply by the table's taps, mask the
store) against ``convt1d_plain`` and ``conv1d_plain``, chain the decoder
tail's three plans with the ReLU of its store against ``decoder_tail_plain``
and JAX's ``fused_decoder_tail``, and emulate 3xTF32 at full width. The f32
core (``csrc/igemm_tf32x3.cuh``: the convs' f32 mode and the decoder tail's
three stages) has a plan of its own (``Tf32x3Plan``): its envelope, its
static list of work items and split-K parts, its C mirror, and a float64
emulation of its reduction order (TF32 halves split once, k8 steps of three
products, tensor-core adds toward zero, the pairwise fold, split-K parts
summed in part order, the tail's ReLU in the store after the part sum) held
against both plain versions and JAX's Pallas kernels in interpret mode; the
W' the tail holds with its folded weights follows the weights' changes and
the layouts. The one-pass bf16 core (``csrc/igemm_bf16.cuh``) has a plan of
its own (``Bf16Plan``): its strides, tiles and envelope, its C mirror, and a
float64 emulation of its reduction order held against both plain versions
and JAX's XLA conv. The kernels themselves are held against the plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import dataclasses
import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.ops import conv as jax_conv
from melogan_tpu.ops.pallas import decoder as jax_decoder
from melogan_tpu.ops.pallas.conv1d import _convt_taps

from melogan_torch.ops import _build, igemm
from melogan_torch.ops.conv1d import conv1d_plain, conv_out_len
from melogan_torch.ops.convt import convt1d_plain, convt_out_len
from melogan_torch.models.gan import GeneratorDecoder
from melogan_torch.ops import decoder as decoder_ops
from melogan_torch.ops.decoder import decoder_tail_plain, stage_plans
from melogan_torch.precision import round_bf16

ROOT = Path(__file__).resolve().parents[1]
GRID = [(k, s) for k in range(1, 8) for s in range(1, 5)]
CHANNELS = [(4, 17), (17, 64), (64, 4)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def run_plan(plan, x, w, bias=None, matmul=torch.matmul):
    """The core's arithmetic in torch: for each (class, offset) of the table
    one product of the gathered rows σ·t + o_min + q with w[tap], into the
    columns of that class; then Y (B, rows, classes·Cout) read as
    (B, rows·classes, Cout) and cut at Lout."""
    b = x.shape[0]
    idx = plan.sigma * torch.arange(plan.rows)[:, None] + plan.o_min + torch.arange(plan.q)
    inside = ((idx >= 0) & (idx < plan.l)).to(x.dtype)
    rows = x[:, idx.clamp(0, plan.l - 1)] * inside[None, :, :, None]  # (B, rows, Q, Cin)
    y = x.new_zeros((b, plan.rows, plan.n))
    for r in range(plan.classes):
        for q in range(plan.q):
            tap = plan.taps[r][q]
            if tap >= 0:
                y[:, :, r * plan.cout:(r + 1) * plan.cout] += matmul(rows[:, :, q], w[tap])
    if bias is not None:
        y = y + bias.repeat(plan.classes)
    return y.reshape(b, plan.rows * plan.classes, plan.cout)[:, :plan.lout]


def _convt_geometries(k, s, l=9):
    for p in range(k):
        for op in range(s):
            if convt_out_len(l, k, s, p, op) > 0:
                yield p, op


@pytest.mark.parametrize("k,s", GRID)
def test_convt_tap_table_matches_jax(k, s):
    """The plan's (class, offset) → w tap table is exactly JAX's
    ``_convt_taps`` with the flip undone (tap j of the flipped weight is
    w[K−1−j]), at every padding and output_padding with Lout > 0. Exact."""
    for p, op in _convt_geometries(k, s):
        plan = igemm.convt_plan(2, 9, 4, 4, k, s, p, op)
        by_class = [_convt_taps(k, s, p, r) for r in range(s)]
        offs = [off for taps in by_class for _, off in taps]
        assert (plan.o_min, plan.q) == (min(offs), max(offs) - min(offs) + 1)
        assert plan.q <= min(k, igemm.MAX_Q)
        for r, taps in enumerate(by_class):
            want = {(k - 1 - j, off - plan.o_min) for j, off in taps}
            got = {(tap, q) for q, tap in enumerate(plan.taps[r]) if tap >= 0}
            assert got == want, (p, op, r)


@pytest.mark.parametrize("k,s", GRID)
def test_convt_plan_executes_to_plain(k, s):
    """The plan run with f32 matmuls equals ``convt1d_plain`` within 1e-5 of
    the output scale: both sum the same f32 products in other orders."""
    rng = np.random.default_rng(k * 10 + s)
    for p, op in _convt_geometries(k, s):
        for cin, cout in CHANNELS:
            x = _t(rng.normal(size=(2, 9, cin)))
            w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin))
            bias = _t(rng.normal(size=(cout,)))
            plan = igemm.convt_plan(2, 9, cin, cout, k, s, p, op)
            want = convt1d_plain(x, w, bias, s, p, op)
            got = run_plan(plan, x, w, bias)
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


@pytest.mark.parametrize("k,s", GRID)
def test_conv1d_plan_executes_to_plain(k, s):
    """The plan run with f32 matmuls equals ``conv1d_plain`` within 1e-5 of
    the output scale, at every padding below K with Lout > 0."""
    rng = np.random.default_rng(k * 10 + s)
    for p in range(k):
        if conv_out_len(9, k, s, p) <= 0:
            continue
        for cin, cout in CHANNELS:
            x = _t(rng.normal(size=(2, 9, cin)))
            w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin))
            bias = _t(rng.normal(size=(cout,)))
            plan = igemm.conv1d_plan(2, 9, cin, cout, k, s, p)
            want = conv1d_plain(x, w, bias, s, p)
            got = run_plan(plan, x, w, bias)
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


def tf32_rna(a):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits, cut."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a, b):
    """The core's product: a = big + small, both TF32; small·big + big·small
    + big·big, each product exact in f32, summed in f32."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = tf32_rna(a - ab), tf32_rna(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def matmul_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


FULL_WIDTH = [
    # the decoder's three convts (k5 s2 p2 op1) and the ED's four convs
    ("convt", 64, 256, 128, 5, 2, 2, 1),
    ("convt", 128, 128, 64, 5, 2, 2, 1),
    ("convt", 256, 64, 4, 5, 2, 2, 1),
    ("conv1d", 512, 4, 64, 5, 1, 2, 0),
    ("conv1d", 512, 64, 128, 3, 1, 1, 0),
    ("conv1d", 512, 128, 256, 3, 1, 1, 0),
    ("conv1d", 512, 256, 256, 3, 1, 1, 0),
    # the ED's widest input gradient: a stride-1 convT, 256 → 256 channels
    ("convt", 512, 256, 256, 3, 1, 1, 0),
]


@pytest.mark.parametrize("op,l,cin,cout,k,s,p,opad", FULL_WIDTH)
def test_3xtf32_is_f32_accurate_at_full_width(op, l, cin, cout, k, s, p, opad):
    """3xTF32 through the plan at full width, B = 2, within 2e-6 of the
    output scale of a float64 product of the same f32 data (IEEE f32 lands
    near 5e-7); one-pass TF32 misses that by two orders of magnitude, so
    the check tells the two apart."""
    rng = np.random.default_rng(l + cin + cout)
    x = _t(rng.normal(size=(2, l, cin)))
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin))
    if op == "convt":
        plan = igemm.convt_plan(2, l, cin, cout, k, s, p, opad)
    else:
        plan = igemm.conv1d_plan(2, l, cin, cout, k, s, p)
    exact = run_plan(plan, x.double(), w.double())
    scale = float(exact.abs().max())
    err3 = float((run_plan(plan, x, w, matmul=matmul_3xtf32).double() - exact).abs().max())
    err1 = float((run_plan(plan, x, w, matmul=matmul_tf32).double() - exact).abs().max())
    assert err3 <= 2e-6 * scale
    assert err1 > 1e-5 * scale


def run_tail(x, stages, matmul=torch.matmul):
    """The decoder tail as ``decoder_tail_cuda`` runs it: the f32 core's
    three ``stage_plans`` (``convt_plan``) chained through the core's
    algebra, the ReLU of the first two stages in the store."""
    b, m, c0 = x.shape
    widths = [c0] + [int(w.shape[-1]) for w, _ in stages]
    y = x
    for i, (plan, (w, bias)) in enumerate(zip(stage_plans(b, m, widths), stages)):
        y = run_plan(plan, y, w, bias, matmul)
        if i < 2:
            y = torch.relu(y)
    return y


def _tail_inputs(rng, b, m, widths):
    x = rng.normal(size=(b, m, widths[0])).astype(np.float32)
    stages = [((rng.normal(size=(5, cin, cout)) / np.sqrt(5 * cin)).astype(np.float32),
               (0.1 * rng.normal(size=(cout,))).astype(np.float32))
              for cin, cout in zip(widths[:-1], widths[1:])]
    return x, stages


TAIL_SHAPES = [
    # (b, m, widths): narrow widths, M = 5 (a ragged row tile), channel
    # counts that are not multiples of 4, and the main path's full width
    # at M = 64 (max_notes 512) and M = 128 (max_notes 1024)
    (2, 16, (24, 16, 8, 4)),
    (3, 5, (8, 12, 8, 4)),
    (2, 7, (6, 10, 6, 3)),
    (3, 5, (5, 7, 9, 3)),
    (2, 64, (256, 128, 64, 4)),
    (1, 128, (256, 128, 64, 4)),
]


@pytest.mark.parametrize("b,m,widths", TAIL_SHAPES)
def test_decoder_tail_plans_execute_to_plain_and_jax(b, m, widths):
    """The three chained plans, run with f32 matmuls, equal
    ``decoder_tail_plain`` and JAX's ``fused_decoder_tail`` (its Pallas
    kernel in interpret mode, as the JAX tests run it on the CPU) within
    1e-5 of the output scale: all three sum the same f32 products in other
    orders."""
    rng = np.random.default_rng(b * 1000 + m + sum(widths))
    x, stages = _tail_inputs(rng, b, m, widths)
    tstages = [(_t(w), _t(bias)) for w, bias in stages]
    got = run_tail(_t(x), tstages)
    plain = decoder_tail_plain(_t(x), tstages)
    theirs = torch.from_numpy(np.array(jax_decoder.fused_decoder_tail(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(bias)) for w, bias in stages])))
    assert got.shape == plain.shape == theirs.shape == (b, 8 * m, widths[-1])
    for want in (plain, theirs):
        torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


def test_3xtf32_decoder_tail_is_f32_accurate_at_full_width():
    """3xTF32 through the three chained plans at full width (M = 64, B = 2),
    each stage's output stored in f32 as h1 and h2 are, within 2e-6 of the
    output scale of the same chain in float64; one-pass TF32 misses it."""
    x, stages = _tail_inputs(np.random.default_rng(5), 2, 64, (256, 128, 64, 4))
    tstages = [(_t(w), _t(bias)) for w, bias in stages]
    assert all(isinstance(p, igemm.Tf32x3Plan) for p in stage_plans(2, 64, (256, 128, 64, 4)))
    exact = run_tail(_t(x).double(), [(w.double(), bias.double()) for w, bias in tstages])
    scale = float(exact.abs().max())
    err3 = float((run_tail(_t(x), tstages, matmul_3xtf32).double() - exact).abs().max())
    err1 = float((run_tail(_t(x), tstages, matmul_tf32).double() - exact).abs().max())
    assert err3 <= 2e-6 * scale
    assert err1 > 1e-5 * scale


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke_plans(bf16=False, big=()):
    """The plans of the layers ``chip_smoke.py`` launches (``bf16``: the
    bf16 core's, at its ``kernels_bf16`` batches and at ``big`` too)."""
    cs = _chip_smoke()
    if not bf16:
        for b, m in cs.DECODER_CASES:  # B = 1 and 4096 at M = 64, M = 128
            yield from stage_plans(b, m, cs.DECODER_WIDTHS)
    for b in cs.CONVT_BATCHES + tuple(big):
        for l, cin, cout in cs.CONVT_LAYERS:
            yield igemm.convt_plan(b, l, cin, cout, 5, 2, 2, 1, bf16)
    for b in (cs.CONV1D_BATCHES + (cs.ED_BATCH,) + tuple(big)) if bf16 else cs.CONV1D_BATCHES:
        for l, cin, cout, k, s, p, _ in cs.CONV1D_LAYERS:
            yield igemm.conv1d_plan(b, l, cin, cout, k, s, p, bf16)
    if bf16:
        for b in cs.VAE_BATCHES + tuple(big):
            for l, cin, cout, k, s, p, _ in cs.VAE_ENCODER:
                yield igemm.conv1d_plan(b, l, cin, cout, k, s, p, True)
            for l, cin, cout in cs.VAE_DECODER:
                yield igemm.convt_plan(b, l, cin, cout, 5, 2, 2, 1, True)
    for (l, cin, cout, k, s, p, op), transposed, _ in cs.BACKWARD_LAYERS:
        for b in (cs.TRAIN_BATCH,) + tuple(big):
            if transposed:  # dx = conv1d(g, wᵀ): g has the convT's output shape
                lg = convt_out_len(l, k, s, p, op)
                yield igemm.conv1d_plan(b, lg, cout, cin, k, s, p, bf16)
            else:  # dx = convT(g, wᵀ)
                lg = conv_out_len(l, k, s, p)
                yield igemm.convt_plan(b, lg, cout, cin, k, s, p, (l + 2 * p - k) % s, bf16)


CORES = ("tf32x3",)  # the f32 core's Tf32x3Plan (the bf16 core's Bf16Plan: its own tests below)


def _corners(core):
    for k in (1, 3, 7):
        for s in (1, 2, 16):
            for cin in (4, 17, 256):
                for cout in (4, 66, 256):
                    yield igemm.conv1d_plan(8, 600, cin, cout, k, s, k // 2)
                    yield igemm.convt_plan(8, 600, cin, cout, k, s, k // 2, s - 1)


@pytest.mark.parametrize("core", CORES)
def test_shared_memory_envelope(core):
    """Every f32 plan ``chip_smoke.py`` launches (the f32 convs and the
    decoder tail's three stages), and the corners of the limits (K ≤ 7,
    stride ≤ 16), fit 227 KB of shared memory in the ring of
    ``igemm_tf32x3.cuh``."""
    plans = list(_chip_smoke_plans())
    assert len(plans) > 25 and all(isinstance(p, igemm.Tf32x3Plan) for p in plans)
    plans += list(_corners(core))
    assert igemm.convt_plan(2048, 512, 64, 4, 5, 2, 2, 1) in plans  # the tail at M = 128, stage 3
    for plan in plans:
        assert plan.smem_bytes <= igemm.SMEM_LIMIT, plan
        assert isinstance(plan, igemm.Tf32x3Plan) and plan.stages in (2, 3)
        assert plan.stage_floats % 32 == 0 and plan.land_rows * plan.cw * 4 % 128 == 0  # TMA boxes


@pytest.mark.parametrize("core", CORES)
def test_tiles_follow_the_shape(core):
    """Narrow N takes a narrow tile (the decoder's 4-channel layer straddles
    both parity classes in one 8-wide tile); Cin = 4 stages 4 channels a
    chunk in im2col planes, so 5 taps reduce 32 deep (to a pair of k8
    steps), not 5·8; wide layers take 128 columns, and a class reads only
    the offsets it uses."""
    plan = igemm.convt_plan
    last = plan(4096, 256, 64, 4, 5, 2, 2, 1)
    assert (last.n, last.tile_n, last.tile_m) == (8, 8, 128)
    dec1 = plan(4096, 64, 256, 128, 5, 2, 2, 1)
    assert (dec1.n, dec1.tile_n, dec1.q, dec1.o_min) == (256, 128, 3, -1)
    assert dec1.taps == ((4, 2, 0), (-1, 3, 1))
    ed1 = igemm.conv1d_plan(32, 512, 4, 64, 5, 1, 2)
    assert (ed1.cw, ed1.im2col, ed1.depth(0), ed1.a_planes, ed1.tile_n) == (4, True, 32, 8, 64)
    assert [dec1.depth(t) for t in range(dec1.n_tiles)] == [48, 32]  # class 1 skips an offset
    with pytest.raises(ValueError, match="K <= 7"):
        plan(2, 9, 4, 4, 8, 2, 0, 0)
    with pytest.raises(ValueError, match="stride <= 16"):
        igemm.conv1d_plan(2, 90, 4, 4, 3, 17, 0)


def _header_ints(name):
    header = (ROOT / "melogan_torch" / "csrc" / name).read_text()
    body = re.search(r"struct Plan \{(.*?)\};", header, re.S).group(1)
    ints = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line.startswith("int "):
            ints += [n.strip() for n in line[4:].rstrip(";").split(",")]
    assert "signed char taps[kMaxClasses][kMaxQ];" in body
    return ints


@pytest.mark.parametrize("core", CORES)
def test_c_plan_mirrors_the_header(core):
    """``CTf32x3Plan`` has the int fields of ``igemm_tf32x3::Plan`` in the
    header's order, then the 16 × 8 tap table, and carries the plan's
    values."""
    ints = _header_ints("igemm_tf32x3.cuh")
    assert [f for f, _ in igemm.CTf32x3Plan._fields_] == ints + ["taps"]
    plan = igemm.convt_plan(4096, 64, 256, 128, 5, 2, 2, 1)
    c = plan.c_struct()
    assert (c.n, c.classes, c.rows, c.q, c.o_min) == (256, 2, 64, 3, -1)
    for f in ints:
        assert getattr(c, f) == getattr(plan, f), f
    assert c.smem_bytes == plan.smem_bytes
    table = bytes(c)[-igemm.MAX_CLASSES * igemm.MAX_Q:]
    assert list(np.frombuffer(table, np.int8)[:16]) == [4, 2, 0, -1, -1, -1, -1, -1,
                                                        -1, 3, 1, -1, -1, -1, -1, -1]
    assert all(v == -1 for v in np.frombuffer(table, np.int8)[16:])


def test_headers_make_every_library_stale(tmp_path, monkeypatch):
    """An edit to a shared header (``csrc/*.cuh``) rebuilds every kernel
    library, as an edit to its own ``.cu`` does."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text("")
    header = csrc / "core.cuh"
    header.write_text("")
    for name in ("a", "b"):
        _build.library_path(name).write_bytes(b"")
        os.utime(_build.library_path(name), (1000, 1000))
    for p in (csrc / "a.cu", csrc / "b.cu", header):
        os.utime(p, (900, 900))
    assert _build.sources("a") == [csrc / "a.cu", header]
    assert not _build.is_stale("a") and not _build.is_stale("b")
    os.utime(header, (1100, 1100))
    assert _build.is_stale("a") and _build.is_stale("b")
    os.utime(header, (900, 900))
    os.utime(csrc / "a.cu", (1100, 1100))
    assert _build.is_stale("a") and not _build.is_stale("b")


# --- the f32 mode's core (csrc/igemm_tf32x3.cuh) ----------------------------


def _f32_conv_plans():
    """The f32 plans of every conv ``chip_smoke.py`` launches on the card:
    ``kernels`` (and the decoder's layers at 65536, the ``bench`` batch),
    ``kernels_ed``, ``kernels_vae``, ``backward_route`` and ``kernels_tp``."""
    cs = _chip_smoke()

    def dx(layers, b):
        for (l, cin, cout, k, s, p, op), transposed, _ in layers:
            if transposed:
                yield igemm.conv1d_plan(b, convt_out_len(l, k, s, p, op), cout, cin, k, s, p)
            else:
                yield igemm.convt_plan(b, conv_out_len(l, k, s, p), cout, cin, k, s, p, (l + 2 * p - k) % s)

    for b in cs.CONVT_BATCHES + (65536,):
        for l, cin, cout in cs.CONVT_LAYERS:
            yield igemm.convt_plan(b, l, cin, cout, 5, 2, 2, 1)
    for b in cs.CONV1D_BATCHES + (cs.ED_BATCH,):
        for l, cin, cout, k, s, p, _ in cs.CONV1D_LAYERS:
            yield igemm.conv1d_plan(b, l, cin, cout, k, s, p)
    for b in cs.VAE_BATCHES:
        for l, cin, cout, k, s, p, _ in cs.VAE_ENCODER:
            yield igemm.conv1d_plan(b, l, cin, cout, k, s, p)
        for l, cin, cout in cs.VAE_DECODER:
            yield igemm.convt_plan(b, l, cin, cout, 5, 2, 2, 1)
    for l, cin, cout in cs.TP_CONVT_LAYERS:
        yield igemm.convt_plan(cs.TRAIN_BATCH, l, cin, cout, 5, 2, 2, 1)
    for l, cin, cout, k, s, p, _ in cs.TP_CONV1D_LAYERS:
        yield igemm.conv1d_plan(cs.TRAIN_BATCH, l, cin, cout, k, s, p)
    yield from dx(cs.BACKWARD_LAYERS + cs.VAE_BACKWARD + cs.TP_BACKWARD_LAYERS, cs.TRAIN_BATCH)
    yield from dx(cs.ED_BACKWARD, cs.ED_BATCH)


def test_tf32x3_plan_geometry_and_envelope():
    """Every f32 conv plan of ``chip_smoke.py`` (the decoder's layers up to
    B = 65536, the tensor-parallel shards) and the corners of the limits:
    shared memory within 227 KB, at most one persistent CTA an SM, TMA boxes
    of at most 256 rows landing 128-byte aligned, halo planes whose 16-byte
    rows put the split's 8 lanes in 8 bank groups, and the arithmetic the
    kernel's ``plan_ok`` checks. Every shipped shape's rows of Cin floats
    allow a tensor map (Cin % 4 == 0), and split-K parts appear where the
    items alone fill less than the card."""
    shipped = list(_f32_conv_plans())
    assert len(shipped) > 60 and all(p.cin % 4 == 0 for p in shipped)
    for p in shipped + list(_corners("tf32x3")):
        assert isinstance(p, igemm.Tf32x3Plan) and p.smem_bytes <= igemm.SMEM_LIMIT, p
        assert 1 <= p.grid <= igemm.SMS and p.grid <= p.units == p.items * p.parts
        assert p.items == p.n_tiles * -(-p.batch * -(-p.rows // 64) // 2)
        assert 1 <= p.parts <= p.chunks and (p.parts == 1 or p.items < igemm.SMS)
        assert p.box_rows % 8 == 0 and p.box_rows <= 256 and p.land_rows >= p.win_rows == 63 * p.sigma + p.q
        assert p.d_max % 16 == 0 and all(p.depth(t) <= p.d_max for t in range(p.n_tiles))
        if p.im2col:
            assert p.cw == 4 and p.a_planes >= p.d_max // 4
        else:
            g = p.cw // 4
            assert p.planes == min(p.sigma, p.q) and p.plane_rows >= 64 + (p.q - 1) // p.sigma
            assert len({(c * p.plane_rows + j) % 8 for c in range(g) for j in range(8 // g)}) == 8
        assert p.smem_bytes == 4 * (p.stages * p.stage_floats + 2 * p.a_floats) + igemm.TF32_BARRIER_BYTES


def test_tf32x3_work_list_covers_each_tile_once():
    """The persistent CTAs' static walk (CTA i takes units i, i + grid, ...)
    visits every unit once; the units' items cover every (64-row tile, N
    tile) pair once, N tiles first (consecutive items share their N tile);
    an item's split-K parts cover its chunks once, in order."""
    cs = _chip_smoke()
    plans = [igemm.convt_plan(1, 64, 256, 128, 5, 2, 2, 1), igemm.convt_plan(32, 64, 128, 128, 5, 2, 2, 1),
             igemm.conv1d_plan(32, 128, 128, 128, 5, 2, 2), igemm.conv1d_plan(7, 100, 20, 70, 3, 1, 1),
             igemm.conv1d_plan(cs.TRAIN_BATCH, 512, 256, 256, 3, 1, 1), igemm.convt_plan(3, 37, 12, 6, 7, 3, 3, 2)]
    assert any(p.parts > 1 for p in plans) and any(p.parts == 1 for p in plans)
    for p in plans:
        walked = sorted(u for cta in range(p.grid) for u in range(cta, p.units, p.grid))
        assert walked == list(range(p.units))
        tiles = {}
        for u in walked:
            item, part = divmod(u, p.parts)
            nt, ri = divmod(item, p.row_items)
            for wt in (2 * ri, 2 * ri + 1):
                if wt < p.wg_tiles:
                    tiles.setdefault((wt, nt), []).append(part)
        assert sorted(tiles) == [(wt, nt) for wt in range(p.wg_tiles) for nt in range(p.n_tiles)]
        assert all(parts == list(range(p.parts)) for parts in tiles.values())
        bounds = [p.part_chunks(q) for q in range(p.parts)]
        assert bounds[0][0] == 0 and bounds[-1][1] == p.chunks
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(bounds, bounds[1:] + [(p.chunks, None)]))


def emulate_tf32x3(plan, x, w, bias=None, arrival=None, in_arrival_order=False, split=("x", "w"),
                   relu=""):
    """The f32 core's arithmetic in its reduction order, in float64 where the
    card is exact: x and w each split once into big = rna(a) and small =
    rna(a − big) (``split`` names the operands that are, the other keeps
    its big half alone); per N tile its active offsets; per split-K part its
    chunks, per chunk of cw channels the (offset, channel) rows in k8 steps,
    each step's three products (small·big, big·small, big·big) of 8 terms
    summed exactly and added into the pair's partial sum rounded toward zero
    to f32 (the first from zero); each pair's partial sum folded into the
    part's f32 sum by an IEEE add; the parts summed in part order (or in
    ``arrival`` order, ``in_arrival_order``: the mutant); bias by an f32 add;
    ``relu`` "store": max(·, 0) in the store, after the part sum and the bias
    (the decoder tail's first two stages), "parts": also on each split-K
    partial tile (the mutant)."""
    def halves(a, on):
        big = tf32_rna(a)
        return big.double(), (tf32_rna(a - big) if on else torch.zeros_like(a)).double()

    (xb, xs), (wb, ws) = halves(x, "x" in split), halves(w, "w" in split)
    b = x.shape[0]
    y = torch.zeros((b, plan.rows, plan.n), dtype=torch.float32)
    t = torch.arange(plan.rows)
    for nt in range(plan.n_tiles):
        cols = torch.arange(nt * plan.tile_n, min((nt + 1) * plan.tile_n, plan.n))
        r_of, co_of = cols // plan.cout, cols % plan.cout
        act, depth = plan.active(nt), plan.depth(nt)
        kk = torch.arange(depth)
        qi = kk // plan.cw
        qs = torch.tensor([act[min(i, len(act) - 1)] for i in qi.tolist()])
        taps = torch.tensor([[plan.taps[r][q] for r in r_of.tolist()] for q in qs.tolist()])
        rows = plan.sigma * t[:, None] + plan.o_min + qs[None, :]
        inside = (rows >= 0) & (rows < plan.l)
        sums = []
        for part in range(plan.parts):
            acc = torch.zeros((b, plan.rows, len(cols)), dtype=torch.float32)
            lo, hi = plan.part_chunks(part)
            for c in range(lo, hi):
                ch = c * plan.cw + kk % plan.cw
                valid = (qi < len(act)) & (ch < plan.cin)
                chc = ch.clamp(max=plan.cin - 1)
                mask_a = inside & valid
                ab = xb[:, rows.clamp(0, plan.l - 1), chc] * mask_a
                as_ = xs[:, rows.clamp(0, plan.l - 1), chc] * mask_a
                mask_w = (taps >= 0) & valid[:, None]
                wkb = wb[taps.clamp(min=0), chc[:, None], co_of[None, :]] * mask_w
                wks = ws[taps.clamp(min=0), chc[:, None], co_of[None, :]] * mask_w
                for s in range(0, depth // 8, 2):
                    part_sum = None
                    for h in (0, 1):
                        sl = slice(8 * (s + h), 8 * (s + h) + 8)
                        for a, bm in ((as_, wkb), (ab, wks), (ab, wkb)):
                            prod = a[..., sl] @ bm[sl]
                            part_sum = _rz32(prod if part_sum is None else part_sum.double() + prod)
                    acc = acc + part_sum
            sums.append(torch.relu(acc) if relu == "parts" and plan.parts > 1 else acc)
        order = list(arrival) if in_arrival_order else list(range(plan.parts))
        total = sums[order[0]]
        for q in order[1:]:
            total = total + sums[q]
        y[..., cols] = total
    if bias is not None:
        y = y + bias.repeat(plan.classes)
    if relu:
        y = torch.relu(y)
    return y.reshape(b, plan.rows * plan.classes, plan.cout)[:, :plan.lout]


TF32X3_SHAPES = [
    # (op, batch the plan is made for, L, Cin, Cout, K, s, p, op): a halo conv at
    # stride 2 split into parts, im2col (Cin = 4), a transposed conv whose N
    # tile straddles both classes, one whose classes use different offsets,
    # and the decoder's stage 1 at batch 1 (256 deep, 32 parts)
    ("conv1d", 2, 40, 24, 20, 5, 2, 2, 0),
    ("conv1d", 2, 33, 4, 12, 5, 1, 2, 0),
    ("convt", 2, 16, 32, 4, 5, 2, 2, 1),
    ("convt", 2, 12, 20, 40, 5, 2, 2, 1),
    ("convt", 1, 64, 256, 128, 5, 2, 2, 1),
]


@pytest.mark.parametrize("op,batch,l,cin,cout,k,s,p,opad", TF32X3_SHAPES)
def test_tf32x3_emulation_matches_plain_and_jax_pallas(op, batch, l, cin, cout, k, s, p, opad):
    """The f32 core's reduction order, emulated on the plan of the shape's
    own batch (split-K parts included), within 1e-6 of the output scale of
    a float64 conv of the same f32 data, of the plain version and of JAX's
    Pallas kernel in interpret mode (as the JAX tests run it on the CPU):
    f32-accurate sums of the same products in other orders."""
    rng = np.random.default_rng(l + cin + cout + k)
    x = _t(rng.normal(size=(batch, l, cin)))
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin))
    bias = _t(0.1 * rng.normal(size=(cout,)))
    if op == "convt":
        plan = igemm.convt_plan(batch, l, cin, cout, k, s, p, opad)
        plain = convt1d_plain(x, w, bias, s, p, opad)
        theirs = jax_conv.conv_transpose1d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), s, p, opad, pallas=True)
    else:
        plan = igemm.conv1d_plan(batch, l, cin, cout, k, s, p)
        plain = conv1d_plain(x, w, bias, s, p)
        theirs = jax_conv.conv1d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), s, p, pallas=True)
    theirs = torch.from_numpy(np.array(theirs)) + bias
    got = emulate_tf32x3(plan, x, w, bias)
    exact = run_plan(plan, x.double(), w.double(), bias.double())
    scale = float(exact.abs().max())
    assert got.shape == plain.shape == theirs.shape == exact.shape
    for want in (exact, plain, theirs):
        assert float((got.double() - want.double()).abs().max()) <= 1e-6 * scale


def test_tf32x3_emulation_mutants_fail():
    """The emulation's checks catch the faults the design rules out: summed
    in the order the split-K parts arrive, two launches whose parts arrive
    in other orders differ in their bits (the card's launches must repeat
    bit for bit); with only one operand split into TF32 halves, the sums
    miss 1e-6 of the scale."""
    rng = np.random.default_rng(11)
    x = _t(rng.normal(size=(1, 64, 256)))
    w = _t(rng.normal(size=(5, 256, 128)) / np.sqrt(5 * 256))
    plan = igemm.convt_plan(1, 64, 256, 128, 5, 2, 2, 1)
    assert plan.parts > 2
    first, later = list(range(plan.parts)), list(reversed(range(plan.parts)))
    fixed = [emulate_tf32x3(plan, x, w, arrival=order) for order in (first, later)]
    assert torch.equal(*fixed)
    moved = [emulate_tf32x3(plan, x, w, arrival=order, in_arrival_order=True) for order in (first, later)]
    assert not torch.equal(*moved)
    exact = run_plan(plan, x.double(), w.double())
    scale = float(exact.abs().max())
    assert float((fixed[0].double() - exact).abs().max()) <= 1e-6 * scale
    for split in (("x",), ("w",)):
        one = emulate_tf32x3(plan, x, w, split=split)
        assert float((one.double() - exact).abs().max()) > 1e-5 * scale, split


def emulate_tail(x, stages):
    """The decoder tail as ``decoder_tail_cuda`` computes it: the f32 core's
    arithmetic on each of the three ``stage_plans``, h1 and h2 stored in
    f32, the ReLU in the first two stages' store."""
    b, m, c0 = x.shape
    widths = (c0,) + tuple(int(w.shape[-1]) for w, _ in stages)
    y = x
    for i, (plan, (w, bias)) in enumerate(zip(stage_plans(b, m, widths), stages)):
        y = emulate_tf32x3(plan, y, w, bias, relu="store" if i < 2 else "")
    return y


@pytest.mark.parametrize("b,m,widths", TAIL_SHAPES)
def test_tf32x3_decoder_tail_emulation_matches_plain_and_jax(b, m, widths):
    """The tail's three launches in the f32 core's reduction order (split-K
    parts where the batch is small, the ReLU after the part sum) within
    1e-6 of the output scale of the same chain in float64, of
    ``decoder_tail_plain`` and of JAX's ``fused_decoder_tail`` (its Pallas
    kernel in interpret mode)."""
    rng = np.random.default_rng(b * 1000 + m + sum(widths) + 1)
    x, stages = _tail_inputs(rng, b, m, widths)
    tstages = [(_t(w), _t(bias)) for w, bias in stages]
    got = emulate_tail(_t(x), tstages).double()
    exact = run_tail(_t(x).double(), [(w.double(), bias.double()) for w, bias in tstages])
    plain = decoder_tail_plain(_t(x), tstages)
    theirs = torch.from_numpy(np.array(jax_decoder.fused_decoder_tail(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(bias)) for w, bias in stages])))
    scale = float(exact.abs().max())
    assert got.shape == exact.shape == plain.shape == theirs.shape == (b, 8 * m, widths[-1])
    for want in (exact, plain.double(), theirs.double()):
        assert float((got - want).abs().max()) <= 1e-6 * scale


def test_tf32x3_relu_on_split_k_partials_fails():
    """A ReLU in the store of every split-K partial tile, and not only of
    the summed tile, misses the float64 stage by far: at batch 1 the
    decoder tail's first stage runs in parts, whose partial sums are often
    negative where the whole sum is not. The store's ReLU after the part sum
    stays within 1e-6 of the scale."""
    rng = np.random.default_rng(12)
    x = _t(rng.normal(size=(1, 64, 256)))
    w = _t(rng.normal(size=(5, 256, 128)) / np.sqrt(5 * 256))
    bias = _t(0.1 * rng.normal(size=(128,)))
    plan = stage_plans(1, 64, (256, 128, 64, 4))[0]
    assert plan.parts > 1
    exact = torch.relu(run_plan(plan, x.double(), w.double(), bias.double()))
    scale = float(exact.abs().max())
    right = emulate_tf32x3(plan, x, w, bias, relu="store")
    assert float((right.double() - exact).abs().max()) <= 1e-6 * scale
    mutant = emulate_tf32x3(plan, x, w, bias, relu="parts")
    assert float((mutant.double() - exact).abs().max()) > 1e-2 * scale


def test_tail_wprep_is_held_per_fold_and_layout():
    """The W' the decoder tail holds is tied to ``folded_stages``' cache
    entry: a second call with the same weights finds the same
    ``TailStages`` and its W' (none made again), one set per layout (batch 1
    and batch 4096 differ); a ``load_state_dict``, an in-place weight
    update and new BN statistics each give a new entry holding no W'. Under
    grad mode every fold is new. The store keeps at most ``MAX_LAYOUTS``, the
    least recently used dropped; a copy holds none."""
    import copy

    widths = (256, 128, 64, 4)
    small, large = (decoder_ops._tail(b, 64, widths).layout for b in (1, 4096))
    assert small != large
    dec = GeneratorDecoder(latent_dim=8, max_notes=512).eval()
    latent = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 8)).astype(np.float32))
    made = []

    def wprep(stages, layout):
        return stages.held((0, layout), lambda: made.append(layout) or object())

    def fold():
        with torch.inference_mode():
            return dec.folded_stages()

    first = fold()
    assert isinstance(first, decoder_ops.TailStages) and fold() is first
    a, b = wprep(first, small), wprep(first, large)
    assert wprep(fold(), small) is a and wprep(fold(), large) is b and len(made) == 2
    assert first.layouts == [(0, small), (0, large)]

    with torch.no_grad():
        dec.deconv[3].weight.add_(0.05)
    after_step = fold()
    assert after_step is not first and after_step.layouts == []
    wprep(after_step, small)
    assert len(made) == 3

    dec.train()
    with torch.no_grad():
        dec.tail(torch.zeros((2, 64, 256)) + latent.mean())  # moves the BN running statistics
    dec.eval()
    after_bn = fold()
    assert after_bn is not after_step and after_bn.layouts == []

    dec.load_state_dict(GeneratorDecoder(latent_dim=8, max_notes=512).state_dict())
    loaded = fold()
    assert loaded is not after_bn and loaded.layouts == [] and fold() is loaded

    assert dec.folded_stages() is not dec.folded_stages()  # grad mode: folded afresh
    for i in range(decoder_ops.MAX_LAYOUTS + 1):
        wprep(loaded, ("layout", i))
    assert loaded.layouts == [(0, ("layout", i)) for i in range(1, decoder_ops.MAX_LAYOUTS + 1)]
    twin = copy.deepcopy(loaded)
    assert isinstance(twin, decoder_ops.TailStages) and twin.layouts == []
    assert all(torch.equal(u, v) for s, t in zip(twin, loaded) for u, v in zip(s, t))


def test_tf32x3_x_path_follows_the_tensor_map_rule():
    """x goes by TMA where a tensor map can describe it (rows of Cin floats
    a multiple of 16 bytes, a 16-byte aligned base), else by 4-byte
    ``cp.async``: Cin 17, or a base one float past a 16-byte boundary."""
    plan = igemm.conv1d_plan(2, 70, 16, 12, 3, 1, 1)
    assert igemm.tf32_x_path(plan, 4096) == "tma"
    assert igemm.tf32_x_path(plan, 4100) == "cp.async"
    assert igemm.tf32_x_path(igemm.conv1d_plan(2, 70, 17, 12, 3, 1, 1), 4096) == "cp.async"


def test_f32_ablation_patches_apply_to_the_cores():
    """``profile_conv_bf16 --mode f32 --part ablate`` builds copies of the f32
    core (``igemm_tf32x3.cuh``, which the convs and the decoder tail
    include) with one phase taken out by text patches. Each patch finds its
    text once and changes it."""
    from melogan_torch import profile_conv_bf16 as tool

    text = (ROOT / "melogan_torch" / "csrc" / "igemm_tf32x3.cuh").read_text()
    assert tool.ABLATIONS_TF32X3["full"] == []
    for name, patches in tool.ABLATIONS_TF32X3.items():
        patched = text
        for old, new in patches:
            assert patched.count(old) == 1 and old != new, name
            patched = patched.replace(old, new)
        assert (patched != text) == (name != "full")


# --- the one-pass bf16 core (csrc/igemm_bf16.cuh) ---------------------------


def _corner_plans(bf16):
    for k in (1, 3, 7):
        for s in (1, 2, 16):
            for cin in (4, 6, 17, 256):
                for cout in (4, 66, 256):
                    yield igemm.conv1d_plan(8, 600, cin, cout, k, s, k // 2, bf16)
                    yield igemm.convt_plan(8, 600, cin, cout, k, s, k // 2, s - 1, bf16)


def test_bf16_plan_geometry_and_envelope():
    """Every bf16 plan ``chip_smoke.py`` launches, at batches up to 65536,
    and the corners of the limits: shared memory within 227 KB, the grid
    within one launch, bf16 row strides that keep ldmatrix rows 16-byte
    aligned and put the 8 rows of a phase (consecutive A rows, consecutive
    W' rows) in 8 distinct 16-byte bank groups, and the tile arithmetic the
    kernel's ``plan_ok`` checks."""
    plans = list(_chip_smoke_plans(bf16=True, big=(65536,))) + list(_corner_plans(True))
    assert len(plans) > 200
    assert all(isinstance(p, igemm.Bf16Plan) for p in plans)
    for p in plans:
        assert p.smem_bytes <= igemm.SMEM_LIMIT, p
        gx, gy = p.grid
        assert gx < 2**31 and gy == 1
        assert p.threads in (128, 256, 512) and p.tile_m % p.warp_m == 0
        for stride in (p.a_stride, p.w_stride):
            assert stride % 8 == 0 and (stride // 8) % 2 == 1  # 16-byte rows, odd count of them
            assert len({(r * stride * 2 // 16) % 8 for r in range(8)}) == 8
        assert p.a_cols * 4 % 16 == 0 and p.land_floats % 4 == 0 and p.tile_halves % 8 == 0
        assert p.segs * p.seg <= p.tile_m and (p.segs == 1 or p.seg == p.rows)
        assert p.segs * p.l * p.cin < 2**31
        if p.im2col:
            assert p.cin <= p.cw <= 8 and p.chunks == 1 and p.a_rows == p.tile_m
            assert p.a_cols >= max(16, p.q * p.cw) and p.w_rows == p.a_cols
        else:
            assert p.cw in (16, 32, 64) and p.chunks == -(-p.cin // p.cw) and p.w_rows == p.q * p.cw
            assert p.planes == min(p.sigma, p.q)
            # the last row any lane reads: segment, row and halo of the last tap
            last = (p.planes - 1) * p.plane_rows + p.segs * (p.seg + (p.q - 1) // p.sigma) - 1
            assert last < p.a_rows
        assert p.stages in (1, 2) and (p.stages == 1 or p.chunks > 1)


def test_bf16_tiles_follow_the_shape():
    """At the main path's largest batches wide layers take 256-row tiles of
    16 warps (32 × 32), short samples share a tile, Cin = 4 stages im2col
    rows, and narrow N keeps its 8-wide tile; a batch-1 layer takes 64."""
    dec1 = igemm.convt_plan(4096, 64, 256, 128, 5, 2, 2, 1, bf16=True)
    assert (dec1.tile_m, dec1.tile_n, dec1.warp_m, dec1.threads) == (256, 64, 32, 512)
    assert (dec1.segs, dec1.seg, dec1.cw, dec1.chunks, dec1.stages) == (4, 64, 32, 8, 2)
    ed1 = igemm.conv1d_plan(1024, 512, 4, 64, 5, 1, 2, bf16=True)
    assert (ed1.im2col, ed1.cw, ed1.a_cols, ed1.w_rows, ed1.chunks) == (True, 4, 32, 32, 1)
    dec3 = igemm.convt_plan(4096, 256, 64, 4, 5, 2, 2, 1, bf16=True)
    assert (dec3.tile_m, dec3.tile_n, dec3.n) == (128, 8, 8)
    vae1 = igemm.conv1d_plan(256, 512, 4, 32, 5, 2, 2, bf16=True)
    assert (vae1.im2col, vae1.tile_n, vae1.sigma) == (True, 32, 2)
    enc3 = igemm.conv1d_plan(32, 128, 64, 128, 5, 2, 2, bf16=True)
    assert (enc3.planes, enc3.plane_rows, enc3.sigma) == (2, 66, 2)
    one = igemm.convt_plan(1, 64, 256, 128, 5, 2, 2, 1, bf16=True)
    assert (one.tile_m, one.warp_m, one.grid) == (64, 32, (4, 1))
    assert igemm.convt_plan(4096, 64, 256, 128, 5, 2, 2, 1) != dec1  # the 3xTF32 plan is its own


def test_bf16_c_plan_mirrors_the_header():
    """``CBf16Plan`` has the int fields of ``igemm_bf16::Plan`` in the
    header's order, then the 16 × 8 tap table, and carries the plan's
    values (log2 fields included)."""
    header = (ROOT / "melogan_torch" / "csrc" / "igemm_bf16.cuh").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", header, re.S).group(1)
    ints = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line.startswith("int "):
            ints += [n.strip() for n in line[4:].rstrip(";").split(",")]
    assert "signed char taps[kMaxClasses][kMaxQ];" in body
    assert [f for f, _ in igemm.CBf16Plan._fields_] == ints + ["taps"]
    plan = igemm.convt_plan(4096, 64, 256, 128, 5, 2, 2, 1, bf16=True)
    c = plan.c_struct()
    for f in ints:
        want = {"cw_shift": 5, "a_cols_shift": 5}.get(f, getattr(plan, f, None))
        assert getattr(c, f) == want, f
    table = bytes(c)[-igemm.MAX_CLASSES * igemm.MAX_Q:]
    assert list(np.frombuffer(table, np.int8)[:16]) == [4, 2, 0, -1, -1, -1, -1, -1,
                                                        -1, 3, 1, -1, -1, -1, -1, -1]


def _rz32(v):
    """float64 to float32 rounded toward zero, as the tensor cores add."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def emulate_bf16(plan, x, w, bias=None, fold=True):
    """The bf16 core's arithmetic in its reduction order: x and w rounded
    to bf16; per N tile its active offsets; per chunk of cw channels the
    (offset, channel) rows in k16 steps, each step's 16 products summed
    exactly and added into the pair's partial sum rounded toward zero to
    f32 (the first from zero); each pair's partial sum folded into the f32
    sum by an IEEE add (``fold``; else every step into one chain toward
    zero); bias by an f32 add."""
    xr, wr = round_bf16(x).double(), round_bf16(w).double()
    b = x.shape[0]
    y = torch.zeros((b, plan.rows, plan.n), dtype=torch.float32)
    t = torch.arange(plan.rows)
    for n0 in range(0, plan.n, plan.tile_n):
        cols = torch.arange(n0, min(n0 + plan.tile_n, plan.n))
        r_of, co_of = cols // plan.cout, cols % plan.cout
        act = [q for q in range(plan.q) if any(plan.taps[r][q] >= 0 for r in set(r_of.tolist()))]
        depth = len(act) * plan.cw
        ksteps = -(-depth // 16)
        kk = torch.arange(ksteps * 16)
        qs = torch.tensor([act[i] if i < len(act) else 0 for i in (kk // plan.cw).tolist()])
        taps = torch.tensor([[plan.taps[r][q] for r in r_of.tolist()] for q in qs.tolist()])
        rows = plan.sigma * t[:, None] + plan.o_min + qs[None, :]
        acc = torch.zeros((b, plan.rows, len(cols)), dtype=torch.float32)
        for c in range(plan.chunks if depth else 0):
            ch = c * plan.cw + kk % plan.cw
            valid = (kk < depth) & (ch < plan.cin)
            chc = ch.clamp(max=plan.cin - 1)
            a = xr[:, rows.clamp(0, plan.l - 1), chc] * ((rows >= 0) & (rows < plan.l) & valid)
            wk = wr[taps.clamp(min=0), chc[:, None], co_of[None, :]] * ((taps >= 0) & valid[:, None])
            part = None
            for s in range(ksteps):
                prod = a[..., 16 * s:16 * s + 16] @ wk[16 * s:16 * s + 16]
                if not fold:
                    acc = _rz32(acc.double() + prod)
                    continue
                part = _rz32(prod if s % 2 == 0 else part.double() + prod)
                if s % 2 == 1 or s == ksteps - 1:
                    acc = acc + part
        y[..., cols] = acc
    if bias is not None:
        y = y + bias.repeat(plan.classes)
    return y.reshape(b, plan.rows * plan.classes, plan.cout)[:, :plan.lout]


BF16_FULL_WIDTH = [
    # (op, main-path batch, L, Cin, Cout, K, s, p, op): the decoder's three
    # convts, the ED's four convs, the VAE encoder's first (Cin = 4, s2), the
    # ED's widest input gradient (a stride-1 convT 256 → 256) and decoder
    # stage 3's (a conv on g with Cin 4)
    ("convt", 4096, 64, 256, 128, 5, 2, 2, 1),
    ("convt", 4096, 128, 128, 64, 5, 2, 2, 1),
    ("convt", 4096, 256, 64, 4, 5, 2, 2, 1),
    ("conv1d", 1024, 512, 4, 64, 5, 1, 2, 0),
    ("conv1d", 1024, 512, 64, 128, 3, 1, 1, 0),
    ("conv1d", 1024, 512, 128, 256, 3, 1, 1, 0),
    ("conv1d", 1024, 512, 256, 256, 3, 1, 1, 0),
    ("conv1d", 256, 512, 4, 32, 5, 2, 2, 0),
    ("convt", 32, 512, 256, 256, 3, 1, 1, 0),
    ("conv1d", 32, 512, 4, 64, 5, 2, 2, 0),
]


@pytest.mark.parametrize("op,batch,l,cin,cout,k,s,p,opad", BF16_FULL_WIDTH)
def test_bf16_core_emulation_at_full_width(op, batch, l, cin, cout, k, s, p, opad):
    """The bf16 core's reduction order (the plan of the main path's batch:
    its N tiles, chunks, k16 steps and pairwise fold, with the tensor
    cores' adds toward zero), emulated at full width on 2 samples: within
    1e-6 of the output scale of a float64 sum of the same bf16-rounded
    products (the card's gate in ``chip_smoke.py``), and within 2e-6 of
    the plain version (``bf16=True``) and of JAX's XLA conv on the rounded
    operands (on the CPU XLA computes DEFAULT as HIGHEST, so the operands
    are rounded first): f32 sums of the same products in other orders."""
    rng = np.random.default_rng(l + cin + cout + k)
    x = _t(rng.normal(size=(2, l, cin)))
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin))
    bias = _t(0.1 * rng.normal(size=(cout,)))
    if op == "convt":
        plan = igemm.convt_plan(batch, l, cin, cout, k, s, p, opad, bf16=True)
        plain = convt1d_plain(x, w, bias, s, p, opad, bf16=True)
        theirs = jax_conv.conv_transpose1d(jnp.asarray(round_bf16(x).numpy()), jnp.asarray(round_bf16(w).numpy()),
                                           s, p, opad, precision=jax.lax.Precision.HIGHEST, pallas=False)
    else:
        plan = igemm.conv1d_plan(batch, l, cin, cout, k, s, p, bf16=True)
        plain = conv1d_plain(x, w, bias, s, p, bf16=True)
        theirs = jax_conv.conv1d(jnp.asarray(round_bf16(x).numpy()), jnp.asarray(round_bf16(w).numpy()),
                                 s, p, precision=jax.lax.Precision.HIGHEST, pallas=False)
    theirs = torch.from_numpy(np.array(theirs)) + bias
    plan = dataclasses.replace(plan, batch=2)
    got = emulate_bf16(plan, x, w, bias)
    exact = run_plan(plan, round_bf16(x).double(), round_bf16(w).double(), bias.double())
    scale = float(exact.abs().max())
    assert got.shape == plain.shape == theirs.shape == exact.shape
    assert float((got.double() - exact).abs().max()) <= 1e-6 * scale
    for want in (plain, theirs):
        assert float((got - want).abs().max()) <= 2e-6 * scale


def test_bf16_fold_keeps_the_deep_sums_accurate():
    """At the ED's deepest layer (768 products a sum) one chain of
    truncating tensor-core adds drifts further from the float64 sum than
    the pairwise fold does; the fold stays within 1e-6 of the scale."""
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(2, 512, 256)))
    w = _t(rng.normal(size=(3, 256, 256)) / np.sqrt(3 * 256))
    plan = dataclasses.replace(igemm.conv1d_plan(1024, 512, 256, 256, 3, 1, 1, bf16=True), batch=2)
    exact = run_plan(plan, round_bf16(x).double(), round_bf16(w).double())
    scale = float(exact.abs().max())
    folded = float((emulate_bf16(plan, x, w).double() - exact).abs().max())
    chained = float((emulate_bf16(plan, x, w, fold=False).double() - exact).abs().max())
    assert folded <= 1e-6 * scale and folded < chained


def test_bf16_ablation_patches_apply_to_the_core():
    """``profile_conv_bf16 --part ablate`` builds copies of the bf16 core
    with one phase taken out by text patches; each patch still finds its
    text in ``csrc/igemm_bf16.cuh`` and changes it."""
    from melogan_torch import profile_conv_bf16

    text = (ROOT / "melogan_torch" / "csrc" / "igemm_bf16.cuh").read_text()
    assert profile_conv_bf16.ABLATIONS["full"] == []
    for name, patches in profile_conv_bf16.ABLATIONS.items():
        patched = text
        for old, new in patches:
            assert old in patched and old != new, name
            patched = patched.replace(old, new)
        assert (patched != text) == (name != "full")
