"""The geometry of the conv kernels' implicit-GEMM core (``ops/igemm.py``)
on the CPU, without a card.

The CUDA core (``csrc/igemm.cuh``) computes
Y[b, t, n] = bias[n mod Cout] + Σ_q Σ_ci X[b, σ·t + o_min + q, ci] · W'[q, ci, n]
from a plan made here. These tests hold the plan's tap table against the JAX
package's ``_convt_taps``, execute the plan with torch matmuls (the core's
algebra: gather rows by σ·t + o_q, multiply by the table's taps, mask the
store) against ``convt1d_plain`` and ``conv1d_plain``, chain the decoder
tail's three plans with the ReLU of its store against ``decoder_tail_plain``
and JAX's ``fused_decoder_tail``, emulate its 3xTF32 arithmetic at full
width, and check its shared-memory envelope and its C mirror. The kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from melogan_tpu.ops.pallas import decoder as jax_decoder
from melogan_tpu.ops.pallas.conv1d import _convt_taps

from melogan_torch.ops import _build, igemm
from melogan_torch.ops.conv1d import conv1d_plain, conv_out_len
from melogan_torch.ops.convt import convt1d_plain, convt_out_len
from melogan_torch.ops.decoder import decoder_tail_plain, stage_plans

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
    """The decoder tail as ``decoder_tail_cuda`` runs it: the three
    ``stage_plans`` chained through the core's arithmetic, the ReLU of the
    first two stages in the store."""
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


def _chip_smoke_plans():
    cs = _chip_smoke()
    for b, m in cs.DECODER_CASES:  # B = 1 and 4096 at M = 64, M = 128
        yield from stage_plans(b, m, cs.DECODER_WIDTHS)
    for b in cs.CONVT_BATCHES:
        for l, cin, cout in cs.CONVT_LAYERS:
            yield igemm.convt_plan(b, l, cin, cout, 5, 2, 2, 1)
    for b in cs.CONV1D_BATCHES:
        for l, cin, cout, k, s, p, _ in cs.CONV1D_LAYERS:
            yield igemm.conv1d_plan(b, l, cin, cout, k, s, p)
    for (l, cin, cout, k, s, p, op), transposed, _ in cs.BACKWARD_LAYERS:
        b = cs.TRAIN_BATCH
        if transposed:  # dx = conv1d(g, wᵀ): g has the convT's output shape
            lg = convt_out_len(l, k, s, p, op)
            yield igemm.conv1d_plan(b, lg, cout, cin, k, s, p)
        else:  # dx = convT(g, wᵀ)
            lg = conv_out_len(l, k, s, p)
            yield igemm.convt_plan(b, lg, cout, cin, k, s, p, (l + 2 * p - k) % s)


def test_shared_memory_envelope():
    """Every plan ``chip_smoke.py`` launches (the decoder tail's three
    stages among them), and the corners of the limits (K ≤ 7, stride ≤ 16),
    fit 227 KB of shared memory in three stages."""
    plans = list(_chip_smoke_plans())
    assert len(plans) > 29
    assert igemm.convt_plan(2048, 512, 64, 4, 5, 2, 2, 1) in plans  # M = 128, stage 3
    for k in (1, 3, 7):
        for s in (1, 2, 16):
            for cin in (4, 17, 256):
                for cout in (4, 66, 256):
                    plans.append(igemm.conv1d_plan(8, 600, cin, cout, k, s, k // 2))
                    plans.append(igemm.convt_plan(8, 600, cin, cout, k, s, k // 2, s - 1))
    for plan in plans:
        assert plan.smem_bytes <= igemm.SMEM_LIMIT, plan
        assert plan.x_rows == (plan.tile_m - 1) * plan.sigma + plan.q
        assert plan.stage_floats % 4 == 0 and plan.x_stride % 4 == 0  # 16-byte copies
        assert plan.w_rows >= plan.q * plan.cw and plan.w_rows % 8 == 0


def test_tiles_follow_the_shape():
    """Narrow N takes a narrow tile (the decoder's 4-channel layer straddles
    both parity classes in one 8-wide tile); Cin = 4 stages 4 channels a
    chunk, so 5 taps reduce 24 deep, not 5·8; wide layers take 64 columns."""
    last = igemm.convt_plan(4096, 256, 64, 4, 5, 2, 2, 1)
    assert (last.n, last.tile_n, last.tile_m) == (8, 8, 128)
    ed1 = igemm.conv1d_plan(32, 512, 4, 64, 5, 1, 2)
    assert (ed1.cw, ed1.w_rows, ed1.tile_n) == (4, 24, 64)
    dec1 = igemm.convt_plan(4096, 64, 256, 128, 5, 2, 2, 1)
    assert (dec1.n, dec1.tile_n, dec1.q, dec1.o_min) == (256, 64, 3, -1)
    assert dec1.taps == ((4, 2, 0), (-1, 3, 1))
    with pytest.raises(ValueError, match="K <= 7"):
        igemm.convt_plan(2, 9, 4, 4, 8, 2, 0, 0)
    with pytest.raises(ValueError, match="stride <= 16"):
        igemm.conv1d_plan(2, 90, 4, 4, 3, 17, 0)


def test_c_plan_mirrors_the_header():
    """``CPlan`` has the int fields of ``igemm::Plan`` in the header's order,
    then the 16 × 8 tap table, and carries the plan's values."""
    header = (ROOT / "melogan_torch" / "csrc" / "igemm.cuh").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", header, re.S).group(1)
    ints = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line.startswith("int "):
            ints += [n.strip() for n in line[4:].rstrip(";").split(",")]
    assert "signed char taps[kMaxClasses][kMaxQ];" in body
    assert [f for f, _ in igemm.CPlan._fields_] == ints + ["taps"]
    plan = igemm.convt_plan(4096, 64, 256, 128, 5, 2, 2, 1)
    c = plan.c_struct()
    assert (c.n, c.classes, c.rows, c.q, c.o_min, c.cw, c.cw_shift) == (256, 2, 64, 3, -1, 32, 5)
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
