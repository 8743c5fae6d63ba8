"""Generator-decoder tail: the CUDA kernel ``csrc/decoder_tail.cu`` (three
launches of the f32 conv core, ``csrc/igemm_tf32x3.cuh``, on W' planes held
with the weights) and its plain PyTorch version.

Port of ``melogan_tpu/ops/pallas/decoder.py::_decoder_kernel``: (B, M, C0) →
(B, 8·M, C3) through three k5/s2/p2/op1 transposed convolutions with bias and
ReLU after the first two, eval BatchNorm folded into the weights ahead of the
call (:func:`fold_bn_affine`). ``stages`` are three (weight HIO (5, Cin, Cout),
bias (Cout,)) pairs, as in the JAX ``fused_decoder_tail``; a
:class:`TailStages` of them also holds the W' planes the kernel made from
them, so that a warm call launches only the three convs.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import List, NamedTuple, Sequence, Tuple

import torch

from melogan_torch.ops import _build, igemm
from melogan_torch.utils.profiling import span

K = 5
STRIDE = 2
PADDING = 2
_PADLO = K - 1 - PADDING  # 2


def taps(r: int) -> List[Tuple[int, int]]:
    """(tap_j, logical_offset) pairs for output parity class r
    (``_taps`` of the JAX package; w_flip[j] = w[K-1-j])."""
    return [
        (j, (r + j - _PADLO) // STRIDE)
        for j in range(K)
        if (r + j - _PADLO) % STRIDE == 0
    ]


def fold_bn_affine(w, b, bn_mean, bn_var, bn_scale, bn_bias, eps: float = 1e-5):
    """Fold a torch-semantics eval BatchNorm into (w, b) of the preceding
    transposed conv: y = ((conv + b) − µ)·γ/√(σ²+ε) + β. w is HIO, so the
    per-output-channel scale broadcasts over its last axis."""
    g = bn_scale * torch.rsqrt(bn_var + eps)
    return w * g, (b - bn_mean) * g + bn_bias


def decoder_tail_plain(x, stages: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """The tap sum written out: each stage computes both parity classes as
    Σ over ``taps(r)`` of a contiguous slice of the zero-margined input times
    one flipped tap, then interleaves them. f32 matmuls."""
    if len(stages) != 3:
        raise ValueError(f"decoder_tail: expected 3 stages, got {len(stages)}")
    y = x
    for i, (w, bias) in enumerate(stages):
        b, m, _ = y.shape
        yp = torch.nn.functional.pad(y, (0, 0, 1, 1))  # one zero row each side
        wf = torch.flip(w, dims=(0,))
        classes = []
        for r in range(STRIDE):
            acc = bias.expand(b, m, -1)
            for j, off in taps(r):
                acc = acc + yp[:, 1 + off: 1 + off + m] @ wf[j]
            classes.append(acc)
        y = torch.stack(classes, dim=2).reshape(b, STRIDE * m, -1)
        if i < 2:
            y = torch.relu(y)
    return y


def decoder_tail_flops(b: int, m: int, widths: Sequence[int]) -> int:
    """Floating-point operations of the valid taps (2 per MAC): each input
    row meets five taps across the two output parities of a k5/s2/p2/op1
    stage, less the three that fall outside the signal (x[-1] once, x[L]
    twice)."""
    flops, lin = 0, m
    for cin, cout in zip(widths[:-1], widths[1:]):
        flops += 2 * b * (K * lin - 3) * cin * cout
        lin *= STRIDE
    return flops


def _lib():
    lib = _build.load("decoder_tail")
    if not getattr(lib, "_melogan_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.melogan_decoder_tail_prepare.argtypes = [p] * 5 + [i, p]
        lib.melogan_decoder_tail_prepare.restype = ctypes.c_int
        lib.melogan_decoder_tail.argtypes = [p] * 10 + [i, p]
        lib.melogan_decoder_tail.restype = ctypes.c_int
        lib._melogan_typed = True
    return lib


def stage_plans(b: int, m: int, widths: Sequence[int]) -> Tuple[igemm.Tf32x3Plan, ...]:
    """The f32 core's plan of each stage: a k5/s2/p2/op1 transposed conv from
    length m·2^i and widths[i] channels to widths[i + 1] (``convt_plan``,
    cached)."""
    return tuple(igemm.convt_plan(b, m << i, widths[i], widths[i + 1], K, STRIDE, PADDING, 1)
                 for i in range(3))


def wprep_layout(plan: igemm.Tf32x3Plan) -> Tuple[int, ...]:
    """What a stage's W' depends on besides its weights: the N tile, cw, the
    depth a chunk holds at most, and the counts of N tiles and chunks
    (``prep_w``'s block layout). The N tile narrows where the items fill less
    than the card, so batch 1 and batch 4096 take different W'."""
    return plan.tile_n, plan.cw, plan.d_max, plan.n_tiles, plan.chunks


class _Tail(NamedTuple):
    c_plans: ctypes.Array  # the three CTf32x3Plan, as the C entries take them
    layout: Tuple[Tuple[int, ...], ...]
    wprep_floats: int  # the three stages' W', one after another
    ws_floats: int  # the largest split-K partials, then every split-K stage's counters


@functools.lru_cache(maxsize=64)
def _tail(b: int, m: int, widths: Tuple[int, ...]) -> _Tail:
    plans = stage_plans(b, m, widths)
    return _Tail((igemm.CTf32x3Plan * 3)(*(p.c_struct() for p in plans)),
                 tuple(wprep_layout(p) for p in plans), sum(p.wprep_floats for p in plans),
                 max(p.ws_floats for p in plans) + sum(p.items for p in plans if p.parts > 1))


MAX_LAYOUTS = 4  # W' layouts a TailStages holds at most
_HELD_LOCK = threading.Lock()


class TailStages(tuple):
    """The three (weight, bias) stages, and the W' planes the kernel made
    from them: one set for each W' layout (device and the plans'
    ``wprep_layout``) it was called with, made on first use and kept while
    the object lives, at most ``MAX_LAYOUTS`` (the least recently used goes
    first). W' is read-only once made, and the stage tensors must not change
    in place while it is held: new weights come as a new object, as
    ``GeneratorDecoder.folded_stages`` gives one per fold. A copy holds no
    W'."""

    def __new__(cls, stages):
        self = super().__new__(cls, (tuple(s) for s in stages))
        self._held = collections.OrderedDict()
        return self

    def __reduce__(self):
        return TailStages, (tuple(self),)

    def held(self, layout, prepare):
        """The W' of ``layout``: ``prepare()``'s result, made on first use."""
        with _HELD_LOCK:
            entry = self._held.get(layout)
            if entry is None:
                entry = self._held[layout] = prepare()
                if len(self._held) > MAX_LAYOUTS:
                    self._held.popitem(last=False)
            else:
                self._held.move_to_end(layout)
            return entry

    @property
    def layouts(self) -> List[tuple]:
        """The layouts whose W' this object holds, least recently used first."""
        return list(self._held)


def _prepare(stages, tail: _Tail, dev, stream):
    """W' of the three stages in one tensor: three prologue launches."""
    wprep = torch.empty(tail.wprep_floats, device=dev, dtype=torch.float32)
    (w1, _), (w2, _), (w3, _) = stages
    err = _lib().melogan_decoder_tail_prepare(
        w1.data_ptr(), w2.data_ptr(), w3.data_ptr(), wprep.data_ptr(), tail.c_plans, dev.index,
        stream.cuda_stream)
    _build.check(err, "decoder_tail prepare")
    _build.count(decoder_tail_cuda, "prepares")
    return wprep


def _held_wprep(stages: TailStages, tail: _Tail, dev, stream):
    """The stages' W' for this call's layout, made on first use; a stream
    other than the one it was made on waits for it."""
    def prepare():
        wprep = _prepare(stages, tail, dev, stream)
        done = torch.cuda.Event()
        done.record(stream)
        return wprep, stream.cuda_stream, done

    wprep, made_on, done = stages.held((dev.index, tail.layout), prepare)
    if made_on != stream.cuda_stream:
        stream.wait_event(done)
        wprep.record_stream(stream)
    return wprep


def decoder_tail_cuda(x, stages: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Launch ``csrc/decoder_tail.cu`` on PyTorch's current stream: three
    launches of the f32 conv core (x → h1 → h2 → y, ReLU in the first two
    stores), one call and one counted launch. W' comes from ``stages`` where
    it is a :class:`TailStages` that holds it for this layout (a warm call:
    no prologue), else it is made first (three ``prep_w`` launches, counted
    in ``decoder_tail_cuda.prepares``): kept by a :class:`TailStages`, for
    this call alone from any other sequence.
    h1, h2 and the split-K workspace come from the caching allocator on the
    same stream. Raises on what the kernel does not take: non-CUDA, non-f32,
    non-contiguous or misshapen operands, or a plan outside the core's
    envelope."""
    with span("ops.decoder_tail"):
        if x.device.type != "cuda":
            raise ValueError(f"decoder_tail_cuda needs CUDA tensors, got {x.device}")
        if len(stages) != 3:
            raise ValueError(f"decoder_tail: expected 3 stages, got {len(stages)}")
        if x.dim() != 3:
            raise ValueError(f"decoder_tail: x must be (B, M, C0), got {tuple(x.shape)}")
        b, m, c0 = x.shape
        dev = x.device
        widths = (c0,) + tuple(int(w.shape[-1]) for w, _ in stages)
        if m < 1:
            raise ValueError(f"decoder_tail: M={m} must be positive")
        _build.check_operand("decoder_tail", x, "x", dev, (b, m, c0))
        for i, (w, bias) in enumerate(stages):
            _build.check_operand("decoder_tail", w, f"w{i + 1}", dev, (K, widths[i], widths[i + 1]))
            _build.check_operand("decoder_tail", bias, f"b{i + 1}", dev, (widths[i + 1],))
        y = torch.empty((b, 8 * m, widths[3]), device=dev, dtype=torch.float32)
        if b == 0:
            return y
        tail = _tail(b, m, widths)
        stream = torch.cuda.current_stream(dev)
        if isinstance(stages, TailStages):
            wprep = _held_wprep(stages, tail, dev, stream)
        else:
            wprep = _prepare(stages, tail, dev, stream)
        h1 = torch.empty((b, 2 * m, widths[1]), device=dev, dtype=torch.float32)
        h2 = torch.empty((b, 4 * m, widths[2]), device=dev, dtype=torch.float32)
        ws = torch.empty(tail.ws_floats, device=dev, dtype=torch.float32) if tail.ws_floats else None
        (_, b1), (_, b2), (_, b3) = stages
        err = _lib().melogan_decoder_tail(
            x.data_ptr(), wprep.data_ptr(), b1.data_ptr(), b2.data_ptr(), b3.data_ptr(),
            h1.data_ptr(), h2.data_ptr(), y.data_ptr(), ws.data_ptr() if ws is not None else None,
            tail.c_plans, dev.index, stream.cuda_stream,
        )
        _build.check(err, "decoder_tail launch")
        _build.count_launch(decoder_tail_cuda)
        return y


decoder_tail_cuda.launches = 0
decoder_tail_cuda.prepares = 0


def fused_decoder_tail(x, stages: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """(B, M, C0) → (B, 8·M, C3): the kernel for a CUDA tensor, the plain
    version for a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return decoder_tail_cuda(x, stages)
    if x.device.type == "cpu":
        return decoder_tail_plain(x, stages)
    raise ValueError(f"fused_decoder_tail: unsupported device {x.device}")
