"""The benchmark's own yardstick: operation and byte counts from shapes, and
the card's peaks.

The FLOP counts are a copy of the program's ``melogan_torch/utils/flops.py``
(matmul and conv FLOPs only, 1 MAC = 2 FLOPs; a transposed conv counted
over all its taps; the frozen emotion discriminator counted at forward plus
input gradient inside the generator update), taken over the configuration
files' upstream keys so that a later change to the program cannot move the
yardstick. ``benchmark/tests/test_benchmark_yardstick.py`` holds the copy
equal to the original at ``configs/gan.yaml`` and ``configs/ed.yaml``.

Bytes count each input and weight read once and each output written once,
in float32 (the port's kernels take float32 operands in both precisions and
round on the chip). A least time is the larger of the operations over the
peak rate of the configuration's operand type and the bytes over the
memory rate (``peaks.json``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple

from benchmark.reference.model import CRITIC_WIDTHS, DECODER_WIDTHS, PRENET_HIDDEN, ed_blocks

F32 = 4
PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def _linear(d_in: int, d_out: int) -> int:
    return 2 * d_in * d_out


def _conv1d(l_out: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * l_out * c_in * c_out * k


def _convt1d(l_in: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * l_in * c_in * c_out * k


def _reduced(gan) -> int:
    return max(1, gan["MAX_NOTES"] // 8)


def feature_encoder_flops(gan) -> int:
    total, d = 0, gan["NUMERIC_INPUT_DIM"]
    for h in gan["ENCODER_HIDDEN"]:
        total += _linear(d, h)
        d = h
    return total + _linear(d, gan["ENCODER_OUT_DIM"])


def decoder_convs(gan) -> List[Tuple[int, int, int]]:
    """(L in, Cin, Cout) of the decoder's three k5 stride-2 transposed convs."""
    widths = DECODER_WIDTHS + (gan["NOTE_DIM"],)
    r = _reduced(gan)
    return [(r * 2 ** j, widths[j], widths[j + 1]) for j in range(3)]


def generator_flops(gan) -> int:
    in_dim = gan["NOISE_DIM"] + (gan["ENCODER_OUT_DIM"] if gan["USE_NUMERIC_ENCODER"] else 0)
    if gan["INTEGRATION_MODE"] == "conditioning":
        in_dim += gan["LATENT_DIM"]
    total = _linear(in_dim, gan["GEN_HIDDEN"]) + _linear(gan["GEN_HIDDEN"], gan["LATENT_DIM"])
    total += _linear(gan["LATENT_DIM"], PRENET_HIDDEN) + _linear(PRENET_HIDDEN, DECODER_WIDTHS[0] * _reduced(gan))
    return total + sum(_convt1d(l, ci, co, 5) for l, ci, co in decoder_convs(gan))


def sampling_flops_per_sample(gan) -> int:
    """The sampling path: feature encoder plus generator forward."""
    return feature_encoder_flops(gan) + generator_flops(gan)


def critic_flops(gan) -> int:
    l, total, c_in = gan["MAX_NOTES"], 0, gan["NOTE_DIM"]
    for c_out in CRITIC_WIDTHS:
        l = (l + 1) // 2
        total += _conv1d(l, c_in, c_out, 5)
        c_in = c_out
    total += _linear(256, 256)
    cond = gan["ENCODER_OUT_DIM"] if gan["USE_NUMERIC_ENCODER"] else 0
    return total + _linear(256 + cond, 1)


def ed_flops(ed) -> int:
    """ED forward in notes mode: the conv blocks, the projection, the MLP."""
    total = sum(_conv1d(ed["max_notes"], ci, co, k) for ci, co, k in ed_blocks(ed))
    total += _linear(ed_blocks(ed)[-1][1], ed["notes_hidden"])
    d = ed["notes_hidden"]
    for h in ed["mlp_hidden"]:
        total += _linear(d, h)
        d = h
    return total + _linear(d, ed["n_classes"])


def group_step_flops(gan, ed, batch: int) -> int:
    """One group step at ``batch``: ``CRITIC_ITERS`` critic updates (G and FE
    forward without grad, the critic on real and fake at 3× forward each,
    the gradient penalty at about 6×) and one generator update (3× the
    forward of FE, G and the critic, 2× the frozen ED's)."""
    f_c, f_g, f_f, f_e = critic_flops(gan), generator_flops(gan), feature_encoder_flops(gan), ed_flops(ed)
    critic_step = batch * (f_g + f_f + 12 * f_c)
    gen_step = batch * (3 * (f_g + f_f + f_c) + 2 * f_e)
    return max(1, gan["CRITIC_ITERS"]) * critic_step + gen_step


# ---------------------------------------------------------------------------
# work of the port's conv cores, from shapes
# ---------------------------------------------------------------------------

def _conv_bytes(rows: int, l_in: int, c_in: int, l_out: int, c_out: int, k: int, bias: bool) -> int:
    return F32 * (rows * l_in * c_in + k * c_in * c_out + (c_out if bias else 0) + rows * l_out * c_out)


def decoder_tail_work(gan, rows: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of the decoder's three transposed convs with their two
    BatchNorms, as one unit: the pre-net's output read once, every weight,
    bias and BatchNorm vector read once, the notes written once."""
    convs = decoder_convs(gan)
    flops = rows * sum(_convt1d(l, ci, co, 5) for l, ci, co in convs)
    weights = sum(5 * ci * co + co for _, ci, co in convs) + 4 * sum(co for _, _, co in convs[:2])
    l0, c0, _ = convs[0]
    l3, c3 = 2 * convs[-1][0], convs[-1][2]
    return flops, F32 * (rows * l0 * c0 + weights + rows * l3 * c3)


def train_conv_calls(gan, ed, batch: int) -> List[Tuple[str, int, int]]:
    """(what, FLOPs, bytes) of every call a group step makes of the port's
    conv cores: the generator's transposed convs forward (in each critic
    update and in the generator update) and their input gradients (the
    generator update), and the frozen ED's convs forward and their input
    gradients (the generator update). Weight gradients run elsewhere."""
    calls = []
    for l, ci, co in decoder_convs(gan):
        f = batch * _convt1d(l, ci, co, 5)
        calls += [("convt_forward", f, _conv_bytes(batch, l, ci, 2 * l, co, 5, True))] * (gan["CRITIC_ITERS"] + 1)
        calls.append(("convt_input_grad", f, _conv_bytes(batch, 2 * l, co, l, ci, 5, False)))
    for ci, co, k in ed_blocks(ed):
        l = ed["max_notes"]
        f = batch * _conv1d(l, ci, co, k)
        calls.append(("ed_conv_forward", f, _conv_bytes(batch, l, ci, l, co, k, True)))
        calls.append(("ed_conv_input_grad", f, _conv_bytes(batch, l, co, l, ci, k, False)))
    return calls


def least_seconds(flops: float, nbytes: float, peaks: dict, precision: str) -> float:
    """The larger of operations over the operand type's peak and bytes over
    the memory rate."""
    return max(flops / (peaks["tflops"][precision] * 1e12), nbytes / (peaks["hbm_tb_per_s"] * 1e12))


def device_peaks(device_name: str) -> Optional[dict]:
    """The ``peaks.json`` entry whose words all occur in the device's name
    (``torch.cuda.get_device_name``), or None."""
    name = device_name.lower()
    for entry in json.loads(PEAKS_FILE.read_text())["devices"]:
        if all(w in name for w in entry["words"]):
            return entry
    return None
