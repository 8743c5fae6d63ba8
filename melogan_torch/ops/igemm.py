"""Geometry of the implicit-GEMM core of the conv kernels (``csrc/igemm.cuh``).

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

The kernel reads w in place through ``Plan.taps`` (class × offset → w tap or
−1). Everything here is host arithmetic on shapes: the tap table, the tile
and the shared-memory layout, which the CPU tests check without a card.
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
STAGES = 3
SMEM_LIMIT = 227 * 1024  # shared memory one H100 block can use
STAGE_BUDGET = 48 * 1024  # per stage: three stages leave room for a second CTA
SMS = 132  # H100 SXM


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


class CPlan(ctypes.Structure):
    """``igemm::Plan`` of ``csrc/igemm.cuh``, field for field."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "batch", "l", "cin", "cout", "k", "stride", "n", "classes", "rows", "lout",
        "sigma", "o_min", "q", "cw", "cw_shift", "tile_m", "tile_n",
        "x_rows", "x_stride", "w_rows", "w_stride", "stage_floats", "smem_bytes",
    )] + [("taps", (ctypes.c_int8 * MAX_Q) * MAX_CLASSES)]


@dataclasses.dataclass(frozen=True)
class Plan:
    batch: int
    l: int
    cin: int
    cout: int
    k: int
    stride: int
    classes: int
    rows: int  # GEMM rows per sample
    lout: int
    sigma: int
    o_min: int
    q: int
    taps: Tuple[Tuple[int, ...], ...]  # [class][q]: w tap, or -1
    tile_m: int
    tile_n: int
    cw: int  # input channels per staged chunk

    @property
    def n(self) -> int:
        return self.classes * self.cout

    @property
    def x_rows(self) -> int:
        """Input rows one tile stages: its own and the halo of the Q offsets."""
        return (self.tile_m - 1) * self.sigma + self.q

    @property
    def x_stride(self) -> int:
        """≡ 8 or 24 mod 32 floats: the 8-byte A loads of a half-warp (4 rows
        × 4 lanes) hit 32 banks at σ = 1."""
        return {4: 8, 8: 24, 16: 24, 32: 40}[self.cw]

    @property
    def w_rows(self) -> int:
        return -(-self.q * self.cw // 8) * 8

    @property
    def w_stride(self) -> int:
        """Twice it is ≡ 8 mod 32 floats: the lanes of a B load read k-rows
        2·i (or 2·i + 1) for i < 4, which then hit 4 bank groups of 8."""
        return self.tile_n + 4

    @property
    def stage_floats(self) -> int:
        return self.x_rows * self.x_stride + self.w_rows * self.w_stride

    @property
    def smem_bytes(self) -> int:
        return STAGES * self.stage_floats * 4

    @property
    def grid(self) -> Tuple[int, int]:
        return self.batch * -(-self.rows // self.tile_m), -(-self.n // self.tile_n)

    def c_struct(self) -> CPlan:
        return _c_struct(self)


@functools.lru_cache(maxsize=256)
def _c_struct(plan: Plan) -> CPlan:
    c = CPlan()
    for f, _ in CPlan._fields_[:-1]:
        setattr(c, f, plan.cw.bit_length() - 1 if f == "cw_shift" else getattr(plan, f))
    for r in range(MAX_CLASSES):
        for q in range(MAX_Q):
            c.taps[r][q] = plan.taps[r][q] if r < plan.classes and q < plan.q else -1
    return c


def _tile(batch: int, rows: int, n: int) -> Tuple[int, int]:
    """(tile_m, tile_n): N tiles of 8-32 for narrow outputs (Cout = 4 at
    stride 1 or 2); 64 wide otherwise, 128 rows tall where the rows and the
    grid (two CTAs per SM) allow."""
    for tn in (8, 16, 32):
        if n <= tn:
            return 128, tn
    tall = batch * -(-rows // 128) * -(-n // 64)
    return (128 if rows >= 128 and tall >= 2 * SMS else 64), 64


def _plan(batch, l, cin, cout, k, stride, classes, rows, lout, sigma, o_min, q, taps) -> Plan:
    tile_m, tile_n = _tile(batch, rows, classes * cout)
    cw_max = min(32, max(4, 1 << (cin - 1).bit_length()))
    plan = None
    for cw in (32, 16, 8, 4):
        if cw > cw_max:
            continue
        plan = Plan(batch, l, cin, cout, k, stride, classes, rows, lout, sigma, o_min, q,
                    taps, tile_m, tile_n, cw)
        if plan.stage_floats * 4 <= STAGE_BUDGET:
            break
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"igemm: {plan.smem_bytes} bytes of shared memory exceed {SMEM_LIMIT}")
    gx, gy = plan.grid
    if gx >= 2**31 or gy > 65535:
        raise ValueError(f"igemm: grid {plan.grid} exceeds one launch")
    return plan


@functools.lru_cache(maxsize=256)
def conv1d_plan(batch: int, l: int, cin: int, cout: int, k: int, stride: int,
                padding: int) -> Plan:
    check_limits("conv1d", k, stride)
    lout = (l + 2 * padding - k) // stride + 1
    return _plan(batch, l, cin, cout, k, stride, 1, lout, lout, stride, -padding, k,
                 (tuple(range(k)),))


@functools.lru_cache(maxsize=256)
def convt_plan(batch: int, l: int, cin: int, cout: int, k: int, stride: int, padding: int,
               output_padding: int) -> Plan:
    check_limits("convt1d", k, stride)
    lout = (l - 1) * stride - 2 * padding + k + output_padding
    by_class = [convt_taps(k, stride, padding, r) for r in range(stride)]
    offs = [off for taps in by_class for _, off in taps]
    o_min, q = min(offs), max(offs) - min(offs) + 1
    table = tuple(
        tuple(next((k - 1 - j for j, off in taps if off - o_min == qq), -1) for qq in range(q))
        for taps in by_class
    )
    return _plan(batch, l, cin, cout, k, stride, stride, -(-lout // stride), lout, 1, o_min, q,
                 table)
