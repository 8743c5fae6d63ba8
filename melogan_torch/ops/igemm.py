"""Geometry of the implicit-GEMM cores of the conv kernels and the decoder tail.

``conv1d`` and the transposed conv run one generalised conv over
channels-last rows,

    Y[b, t, n] = bias[n mod Cout] + Σ_{q<Q} Σ_ci X[b, σ·t + o_min + q, ci] · W'[q, ci, n]

(rows outside [0, L) are zero), a GEMM whose rows are t, whose columns are n
and whose reduction runs over (q, ci). Column n is tap class r = n div Cout
and output channel co = n mod Cout; row t of class r is output row
classes·t + r, so Y viewed as (B, rows·classes, Cout) is the output:

- conv1d: σ = stride, o_min = −padding, Q = K, one class, W'[q] = w[q].
- transposed conv: σ = 1, one class per output parity r < stride. Q counts
  the distinct x-row offsets of all classes (``convt_taps``), and
  W'[q, :, r·Cout + co] is w[K−1−j, :, co] for the tap j of class r at
  offset o_min + q, or a structural zero.

The cores read w through the plan's ``taps`` (class × offset → w tap or
−1). Everything here is host arithmetic on shapes: the tap table, the tile
and the shared-memory layout, which the CPU tests check without a card.

Two cores take these plans, each with a plan of its own over the same
geometry:

- ``Tf32x3Plan``: the f32 mode of both convs and the decoder tail's three
  stages (``igemm_tf32x3.cuh``; what ``conv1d_plan`` and ``convt_plan``
  return): persistent CTAs that walk a static list of (row tile, N tile)
  work items, split-K parts where the items cannot fill the card, x by TMA
  (or 4-byte ``cp.async``) into a ring, W' split once into TF32 planes in a
  scratch buffer (the convs' per launch, the tail's held with its folded
  weights).
- ``Bf16Plan``: the one-pass bf16 mode (``igemm_bf16.cuh``, ``bf16=True``),
  with its f32 landing ring and bf16 tiles sized in bf16 elements, and its
  A tile staged as planes of rows (a halo) or one flattened (q, ci) row per
  output row (im2col, Cin ≤ 8).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

MAX_K = 7
MAX_STRIDE = 16
MAX_CLASSES = 16  # = MAX_STRIDE: a transposed conv has one class per parity
MAX_Q = 8
SMEM_LIMIT = 227 * 1024  # shared memory one H100 block can use
SMS = 132  # H100 SXM
BF16_BUDGET = 113 * 1024  # bf16 core, 4-warp tiles: two CTAs an SM


def _kept(plan, build):
    """``build(plan)``, the plan's ctypes structure, made once and kept on
    the (frozen) plan, so a launch finds it without hashing the plan."""
    c = plan.__dict__.get("_c_struct")
    if c is None:
        c = build(plan)
        object.__setattr__(plan, "_c_struct", c)
    return c


def convt_taps(k: int, stride: int, padding: int, r: int) -> List[Tuple[int, int]]:
    """Output parity class r: (tap_j, x_offset) pairs with
    out[stride·t + r] = Σ_j x[t + off_j] · w_flipped[j]
    (``_convt_taps`` of the JAX package)."""
    padlo = k - 1 - padding
    return [
        (j, (r + j - padlo) // stride)
        for j in range(k)
        if (r + j - padlo) % stride == 0
    ]


def check_limits(op: str, k: int, stride: int) -> None:
    if not (1 <= k <= MAX_K and 1 <= stride <= MAX_STRIDE):
        raise ValueError(f"{op}: kernel takes K <= {MAX_K}, stride <= {MAX_STRIDE}; "
                         f"got K={k} stride={stride}")


class CBf16Plan(ctypes.Structure):
    """``igemm_bf16::Plan`` of ``csrc/igemm_bf16.cuh``, field for field."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "batch", "l", "cin", "cout", "k", "stride", "n", "classes", "rows", "lout",
        "sigma", "o_min", "q", "cw", "cw_shift", "chunks", "tile_m", "tile_n", "warp_m", "segs", "seg",
        "planes", "plane_rows", "a_rows", "a_cols", "a_cols_shift", "a_stride",
        "w_rows", "w_stride", "stages", "land_floats", "tile_halves", "table_ints", "smem_bytes",
    )] + [("taps", (ctypes.c_int8 * MAX_Q) * MAX_CLASSES)]


def _pow2(v: int) -> int:
    return 1 << (v - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """The bf16 core's plan. Per chunk of ``cw`` input channels, ``stages``
    f32 landing slots (the A rows and the W' rows as copied) and two bf16
    tiles (A, W') that the fragments read. Strides are in bf16 elements:
    ``a_stride`` and ``w_stride`` are odd multiples of 8, so the eight
    16-byte rows of an ldmatrix phase fall in eight bank groups."""
    batch: int
    l: int
    cin: int
    cout: int
    k: int
    stride: int
    classes: int
    rows: int
    lout: int
    sigma: int
    o_min: int
    q: int
    taps: Tuple[Tuple[int, ...], ...]
    tile_m: int
    tile_n: int
    cw: int  # 4 or 8: im2col; 16, 32 or 64: halo
    stages: int  # landing slots, 1 or 2
    warp_m: int  # rows a warp holds, 32 or 64; columns min(tile_n, 32)

    @property
    def n(self) -> int:
        return self.classes * self.cout

    @property
    def segs(self) -> int:
        """Samples a row tile holds: whole samples where one has at most half
        the tile's rows, else one (a run of ``tile_m`` of its rows)."""
        return self.tile_m // self.rows if 2 * self.rows <= self.tile_m else 1

    @property
    def seg(self) -> int:
        """Output rows of each sample in a row tile."""
        return self.rows if self.segs > 1 else self.tile_m

    @property
    def grid(self) -> Tuple[int, int]:
        """One dimension: row tiles × N tiles, N tiles fastest."""
        return -(-self.batch // self.segs) * -(-self.rows // self.seg) * -(-self.n // self.tile_n), 1

    @property
    def im2col(self) -> bool:
        return self.cw <= 8

    @property
    def threads(self) -> int:
        return 32 * (self.tile_m // self.warp_m) * (self.tile_n // min(self.tile_n, 32))

    @property
    def chunks(self) -> int:
        return 1 if self.im2col else -(-self.cin // self.cw)

    @property
    def planes(self) -> int:
        """Halo: input rows split by row mod σ; the planes some tap reads."""
        return 0 if self.im2col else min(self.sigma, self.q)

    @property
    def plane_rows(self) -> int:
        """Each sample's rows and its halo, ``segs`` times."""
        return 0 if self.im2col else self.segs * (self.seg + (self.q - 1) // self.sigma)

    @property
    def a_rows(self) -> int:
        return self.tile_m if self.im2col else self.planes * self.plane_rows

    @property
    def a_cols(self) -> int:
        """Halo: cw channels; im2col: Q·cw flattened, to a power of two ≥ 16."""
        return max(16, _pow2(self.q * self.cw)) if self.im2col else self.cw

    @property
    def a_stride(self) -> int:
        return self.a_cols + 8

    @property
    def w_rows(self) -> int:
        return self.a_cols if self.im2col else self.q * self.cw

    @property
    def w_stride(self) -> int:
        return self.tile_n if (self.tile_n // 8) % 2 else self.tile_n + 8

    @property
    def land_floats(self) -> int:
        return self.a_rows * self.a_cols + self.w_rows * self.tile_n

    @property
    def tile_halves(self) -> int:
        return self.a_rows * self.a_stride + self.w_rows * self.w_stride

    @property
    def table_ints(self) -> int:
        """The x row of each staged (row, cw-group)."""
        return self.a_rows * (self.a_cols // self.cw)

    @property
    def smem_bytes(self) -> int:
        return self.stages * self.land_floats * 4 + 2 * self.tile_halves * 2 + self.table_ints * 4

    def c_struct(self) -> CBf16Plan:
        return _kept(self, _c_struct_bf16)


def _c_struct_bf16(plan: Bf16Plan) -> CBf16Plan:
    c = CBf16Plan()
    shifts = {"cw_shift": plan.cw, "a_cols_shift": plan.a_cols}
    for f, _ in CBf16Plan._fields_[:-1]:
        setattr(c, f, shifts[f].bit_length() - 1 if f in shifts else getattr(plan, f))
    for r in range(MAX_CLASSES):
        for q in range(MAX_Q):
            c.taps[r][q] = plan.taps[r][q] if r < plan.classes and q < plan.q else -1
    return c


def _bf16_plan(batch, l, cin, cout, k, stride, classes, rows, lout, sigma, o_min, q,
               taps) -> Bf16Plan:
    """N tiles as the f32 core's. Wide N: rows in tiles of 256 (16 warps of
    32 × 32, one CTA an SM) where those fill every SM, else 128 (4 warps of
    64 × 32, two CTAs an SM) where those do, else 64 (4 warps of 32 × 32);
    whole samples a tile where a sample is short. cw: 4 or 8 (im2col) for
    Cin ≤ 8, else the largest of 64, 32, 16 that leaves two chunks (so the
    next chunk's copies overlap this one's products) and fits the shared
    memory the CTAs of an SM share, with two landing stages at 256 rows
    (measured on an H100 by ``profile_conv_bf16 --part limits``)."""
    n = classes * cout
    plan = Bf16Plan(batch, l, cin, cout, k, stride, classes, rows, lout, sigma, o_min, q, taps,
                    tile_m=128, tile_n=next((tn for tn in (8, 16, 32) if n <= tn), 64), cw=4,
                    stages=1, warp_m=32)
    if plan.tile_n == 64:
        def ctas(tile_m):
            return dataclasses.replace(plan, tile_m=tile_m).grid[0]
        tile_m, warp_m = (256, 32) if ctas(256) >= SMS else (128, 64) if ctas(128) >= 2 * SMS else (64, 32)
        plan = dataclasses.replace(plan, tile_m=tile_m, warp_m=warp_m)
    budget = SMEM_LIMIT if plan.tile_m == 256 else BF16_BUDGET
    if cin <= 8:
        widths = (4 if cin <= 4 else 8,)
    else:
        widths = tuple(c for c in (64, 32, 16) if c <= max(16, _pow2(cin) // 2))
    # a second landing slot pays only where one CTA holds the SM (256 rows)
    fits = [dataclasses.replace(plan, cw=cw, stages=stages) for cw in widths
            for stages in ((2, 1) if plan.tile_m == 256 and cin > cw else (1,))]
    fitted = next((f for f in fits if f.smem_bytes <= budget), fits[-1])
    if fitted.segs * l * cin >= 2**31:
        raise ValueError(f"igemm: {fitted.segs} samples of {l} x {cin} exceed int offsets")
    return _checked(fitted)


class CTf32x3Plan(ctypes.Structure):
    """``igemm_tf32x3::Plan`` of ``csrc/igemm_tf32x3.cuh``, field for field."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "batch", "l", "cin", "cout", "k", "stride", "n", "classes", "rows", "lout",
        "sigma", "o_min", "q", "cw", "chunks", "tile_n", "n_tiles", "wg_tiles", "row_items",
        "items", "parts", "units", "grid", "win_rows", "box_rows", "boxes", "land_rows",
        "planes", "plane_rows", "a_planes", "d_max", "stages", "w_stage_floats", "land_floats",
        "stage_floats", "a_floats", "wprep_floats", "ws_floats", "scratch_floats", "smem_bytes",
    )] + [("taps", (ctypes.c_int8 * MAX_Q) * MAX_CLASSES)]


TF32_WG_ROWS = 64  # rows a consumer warpgroup holds (one wgmma m64)
TF32_CONSUMERS = 2  # consumer warpgroups a CTA; one producer warp beside them
TF32_BOX_MAX = 256  # rows of one TMA box at most
TF32_MAX_PARTS = 4  # split-K parts at most: the last CTA of an item reads them all
TF32_BARRIER_BYTES = 512  # the ring's mbarriers, split-K flags, the tap table, the k-step tables


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class Tf32x3Plan:
    """The f32 mode's plan (``csrc/igemm_tf32x3.cuh``).

    A CTA is one producer warp and two consumer warpgroups. A consumer
    warpgroup holds 64 output rows t0.. of one sample b (a "warpgroup tile")
    by ``tile_n`` columns; a work item is two consecutive warpgroup tiles by
    one N tile, and the items are listed N tile first, so the items a wave
    of CTAs takes share their W' planes in L2. A unit is an item's part: the
    (offset, channel) reduction runs chunk by chunk of ``cw`` input
    channels, and ``parts`` > 1 splits the chunks into contiguous parts
    whose partial tiles the last CTA to finish one sums in part order.
    ``grid`` persistent CTAs (at most one an SM) walk the units
    ``blockIdx.x, + grid, ...``.

    Per ring stage: the W' planes of the chunk (big then small, each
    ``depth × tile_n`` in wgmma's K-major core matrices, depth ≤ ``d_max``),
    then each warpgroup's window of x rows, ``land_rows`` × cw f32 as TMA
    lands them (``boxes`` boxes of ``box_rows``). Each consumer warpgroup
    splits its window once into big and small TF32 planes (``a_floats``):
    halo (cw ≥ 8) ``planes`` = min(σ, Q) planes by row mod σ, each of ``cw/4``
    channel groups of ``plane_rows`` 16-byte rows, so every tap reads a view
    shifted by whole rows; im2col (cw = 4) ``a_planes`` planes of 64 rows,
    one a tap, so a k8 step spans two taps.

    Scratch (global, ``scratch_floats``): the split W' planes of every
    (N tile, chunk), then the split-K partial tiles, then a counter an item.
    """
    batch: int
    l: int
    cin: int
    cout: int
    k: int
    stride: int
    classes: int
    rows: int
    lout: int
    sigma: int
    o_min: int
    q: int
    taps: Tuple[Tuple[int, ...], ...]
    tile_n: int  # 8, 16, 32, 64 or 128
    cw: int  # input channels a chunk: 4 (im2col), 8, 16 or 32 (halo)
    stages: int  # ring stages, 2 or 3
    parts: int  # split-K parts, 1 for none

    tile_m = TF32_CONSUMERS * TF32_WG_ROWS

    @property
    def n(self) -> int:
        return self.classes * self.cout

    @property
    def im2col(self) -> bool:
        return self.cw == 4

    @property
    def chunks(self) -> int:
        return -(-self.cin // self.cw)

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.tile_n)

    @property
    def wg_tiles(self) -> int:
        return self.batch * -(-self.rows // TF32_WG_ROWS)

    @property
    def row_items(self) -> int:
        return -(-self.wg_tiles // TF32_CONSUMERS)

    @property
    def items(self) -> int:
        return self.row_items * self.n_tiles

    @property
    def units(self) -> int:
        return self.items * self.parts

    @property
    def grid(self) -> int:
        return min(self.units, SMS)

    def part_chunks(self, part: int) -> Tuple[int, int]:
        """Chunks [lo, hi) of split-K part ``part``."""
        return part * self.chunks // self.parts, (part + 1) * self.chunks // self.parts

    @property
    def win_rows(self) -> int:
        """Input rows one warpgroup tile reads: σ·t0 + o_min on."""
        return (TF32_WG_ROWS - 1) * self.sigma + self.q

    @property
    def boxes(self) -> int:
        return -(-self.win_rows // TF32_BOX_MAX)

    @property
    def box_rows(self) -> int:
        """Rows of a TMA box, a multiple of 8 so every box lands 128-byte aligned."""
        return _round_up(-(-self.win_rows // self.boxes), 8)

    @property
    def land_rows(self) -> int:
        return self.boxes * self.box_rows

    @property
    def planes(self) -> int:
        return 0 if self.im2col else min(self.sigma, self.q)

    @property
    def plane_rows(self) -> int:
        """Halo: rows of a plane, padded to ≡ 8/G (mod 8) for G = cw/4 channel
        groups, so the split's 16-byte stores of 8 lanes (G groups of 8/G
        consecutive rows) fall in 8 distinct bank groups."""
        if self.im2col:
            return TF32_WG_ROWS
        need, g = TF32_WG_ROWS + (self.q - 1) // self.sigma, self.cw // 4
        return need + (8 // g - need) % 8

    @property
    def a_planes(self) -> int:
        """im2col: one plane a tap, to a multiple of 4 (a k8 step takes two,
        a pair of k8 steps four)."""
        return _round_up(self.q, 4) if self.im2col else 0

    @property
    def d_max(self) -> int:
        """W' rows (reduction depth) of a chunk at most: every offset, to a
        pair of k8 steps."""
        return _round_up(self.q * self.cw, 16)

    @property
    def w_stage_floats(self) -> int:
        return 2 * self.d_max * self.tile_n

    @property
    def land_floats(self) -> int:
        return TF32_CONSUMERS * self.land_rows * self.cw

    @property
    def stage_floats(self) -> int:
        return self.w_stage_floats + self.land_floats

    @property
    def a_floats(self) -> int:
        """One warpgroup's split planes, big then small."""
        if self.im2col:
            return 2 * self.a_planes * TF32_WG_ROWS * 4
        return 2 * self.planes * (self.cw // 4) * self.plane_rows * 4

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.stages * self.stage_floats + TF32_CONSUMERS * self.a_floats) + TF32_BARRIER_BYTES

    @property
    def wprep_floats(self) -> int:
        return self.n_tiles * self.chunks * self.w_stage_floats

    @property
    def ws_floats(self) -> int:
        return self.items * self.parts * self.tile_m * self.tile_n if self.parts > 1 else 0

    @property
    def scratch_floats(self) -> int:
        """W' planes, split-K partials, then one int counter an item."""
        return self.wprep_floats + self.ws_floats + (self.items if self.parts > 1 else 0)

    def active(self, n_tile: int) -> List[int]:
        """The offsets q some column of N tile ``n_tile`` uses, in order."""
        n0 = n_tile * self.tile_n
        classes = range(n0 // self.cout, (min(n0 + self.tile_n, self.n) - 1) // self.cout + 1)
        return [q for q in range(self.q) if any(self.taps[r][q] >= 0 for r in classes)]

    def depth(self, n_tile: int) -> int:
        """W' rows of a chunk of this N tile: its offsets × cw, to a pair of
        k8 steps."""
        return _round_up(len(self.active(n_tile)) * self.cw, 16)

    def c_struct(self) -> CTf32x3Plan:
        return _kept(self, _c_struct_tf32x3)


def _c_struct_tf32x3(plan: Tf32x3Plan) -> CTf32x3Plan:
    c = CTf32x3Plan()
    for f, _ in CTf32x3Plan._fields_[:-1]:
        setattr(c, f, getattr(plan, f))
    for r in range(MAX_CLASSES):
        for q in range(MAX_Q):
            c.taps[r][q] = plan.taps[r][q] if r < plan.classes and q < plan.q else -1
    return c


def tf32_x_path(plan: Tf32x3Plan, x_ptr: int) -> str:
    """How the producer copies x for ``plan`` from address ``x_ptr``, as
    ``igemm_tf32x3::run`` decides: "tma" where a tensor map can describe x
    (rows of Cin floats a multiple of 16 bytes, a 16-byte aligned base),
    else "cp.async" (4-byte copies into the same ring)."""
    return "tma" if plan.cin % 4 == 0 and x_ptr % 16 == 0 else "cp.async"


def _tf32_fits(plan: Tf32x3Plan) -> bool:
    return plan.smem_bytes <= SMEM_LIMIT


def _tf32x3_plan(batch, l, cin, cout, k, stride, classes, rows, lout, sigma, o_min, q, taps) -> Tf32x3Plan:
    """N tiles of 8, 16, 32 or 64 for N up to that, else 128. cw: 4 (im2col) for
    Cin ≤ 4, else the widest of 32, 16, 8 (at most Cin to a power of two)
    with three ring stages that fits, else with two, else im2col (cw = 4:
    large strides, whose windows are long). Where the items fill less than
    the card, the N tile narrows from 128 to 64 and the chunks split into
    parts: at most one part a chunk, about one unit an SM, and at most
    ``TF32_MAX_PARTS`` (the CTA that finishes an item reads every part's
    tile back, one after another)."""
    n = classes * cout
    plan = Tf32x3Plan(batch, l, cin, cout, k, stride, classes, rows, lout, sigma, o_min, q, taps,
                      tile_n=next((tn for tn in (8, 16, 32, 64) if n <= tn), 128), cw=4, stages=3, parts=1)
    widths = [cw for cw in (32, 16, 8) if cin > 4 and cw <= max(8, _pow2(cin))] + [4]
    fits = [dataclasses.replace(plan, cw=cw, stages=st) for cw in widths for st in (3, 2)]
    fitted = [f for f in fits if _tf32_fits(f)]
    if not fitted:
        raise ValueError(f"igemm: no f32 plan of {l} x {cin} (K={k}, stride={stride}) fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    plan = fitted[0]
    if plan.items < SMS:
        if plan.tile_n == 128:  # twice the items in 64-wide N tiles
            narrow = [f for f in (dataclasses.replace(g, tile_n=64) for g in fits) if _tf32_fits(f)]
            plan = narrow[0] if narrow else plan
        plan = dataclasses.replace(plan, parts=max(1, min(plan.chunks, SMS // plan.items, TF32_MAX_PARTS)))
    if l * cin >= 2**31 or plan.units >= 2**31:
        raise ValueError(f"igemm: {batch} samples of {l} x {cin} exceed one launch")
    return plan


def tf32_variants(plan: Tf32x3Plan) -> List[Tf32x3Plan]:
    """The plan with its N tile, cw and ring stages varied, each that fits."""
    tiles = [plan.tile_n] if plan.tile_n < 64 else [64, 128] if plan.n > 64 else [32, 64]
    widths = [4] if plan.cin <= 4 else [c for c in (32, 16, 8, 4) if c <= max(8, _pow2(plan.cin))]
    out = []
    for tn in tiles:
        for cw in widths:
            for st in (2, 3):
                v = dataclasses.replace(plan, tile_n=tn, cw=cw, stages=st)
                if _tf32_fits(v) and v not in out:
                    out.append(v)
    return out


def _checked(plan):
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"igemm: {plan.smem_bytes} bytes of shared memory exceed {SMEM_LIMIT}")
    gx, gy = plan.grid
    if gx >= 2**31 or gy > 65535:
        raise ValueError(f"igemm: grid {plan.grid} exceeds one launch")
    return plan


@functools.lru_cache(maxsize=256)
def conv1d_plan(batch: int, l: int, cin: int, cout: int, k: int, stride: int,
                padding: int, bf16: bool = False):
    """The plan of a conv1d: the f32 core's (``Tf32x3Plan``), or with
    ``bf16`` the bf16 core's (``Bf16Plan``)."""
    check_limits("conv1d", k, stride)
    lout = (l + 2 * padding - k) // stride + 1
    make = _bf16_plan if bf16 else _tf32x3_plan
    return make(batch, l, cin, cout, k, stride, 1, lout, lout, stride, -padding, k,
                (tuple(range(k)),))


@functools.lru_cache(maxsize=256)
def convt_plan(batch: int, l: int, cin: int, cout: int, k: int, stride: int, padding: int,
               output_padding: int, bf16: bool = False):
    """The plan of a transposed conv: the f32 core's (``Tf32x3Plan``), or
    with ``bf16`` the bf16 core's."""
    check_limits("convt1d", k, stride)
    make = _bf16_plan if bf16 else _tf32x3_plan
    return make(*_convt_geometry(batch, l, cin, cout, k, stride, padding, output_padding))


def _convt_geometry(batch, l, cin, cout, k, stride, padding, output_padding):
    """The generalised conv of a transposed conv: one class a parity, its
    offsets and the tap table."""
    lout = (l - 1) * stride - 2 * padding + k + output_padding
    by_class = [convt_taps(k, stride, padding, r) for r in range(stride)]
    offs = [off for taps in by_class for _, off in taps]
    o_min, q = min(offs), max(offs) - min(offs) + 1
    table = tuple(
        tuple(next((k - 1 - j for j, off in taps if off - o_min == qq), -1) for qq in range(q))
        for taps in by_class
    )
    return batch, l, cin, cout, k, stride, stride, -(-lout // stride), lout, 1, o_min, q, table
