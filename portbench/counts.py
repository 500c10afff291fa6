"""Operations and bytes of the measured work, counted from shapes alone, and
the card's published peaks: the yardstick of the roofline and MFU metrics.

Counts follow the published architecture, not the program's code, so a
later change that computes the same thing another way is measured against
the same work. A multiply-add counts as two operations.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

# NVIDIA H100 SXM, NVIDIA's data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
SR = 16000


def bound_s(ops: float, nbytes: float, peak_flops: float = PEAK_FLOPS["float32"]) -> float:
    """The least seconds a kernel can take: its operations at the peak rate
    or its bytes at the memory rate, whichever is longer."""
    return max(ops / peak_flops, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# K1: the SHC band of YAAPT's spectral track
# ---------------------------------------------------------------------------


def yaapt_geometry(num_samples: int, params: Dict[str, float]) -> Dict[str, int]:
    """Frames of YAAPT's spectral track and the SHC band's geometry for one
    utterance of ``num_samples`` (the published YAAPT options)."""
    fs = params["sr"]
    to_pad = int(params["frame_length"] / 1000 * int(fs)) // 2
    frame_size = int(math.floor(params["frame_length"] * fs / 1000))
    frame_jump = int(math.floor(params["frame_space"] * fs / 1000))
    nfft = int(params["fft_length"])
    size = num_samples + 2 * to_pad
    frames = len(range(frame_size // 2, size - frame_size // 2, frame_jump))
    delta = fs / nfft
    window = int(math.floor(params["shc_window"] / delta))
    window += 1 - window % 2
    max_shc = int(math.floor((params["f0_max"] + params["shc_pwidth"] * 2) / delta))
    min_shc = int(math.ceil(params["f0_min"] / delta))
    harm = int(params["shc_numharms"]) + 1
    n_out = max_shc - min_shc + 1
    columns = (min_shc + n_out - 1) * harm + window  # padded magnitude columns read
    return {"frames": frames, "min_shc": min_shc, "n_out": n_out, "harm": harm,
            "window": window, "columns": columns}


def k1_bound_s(batch: int, num_samples: int, params: Dict[str, float]) -> float:
    """K1 on a [batch, num_samples] batch: each output is a sum over the
    window of products over the harmonics (window x harmonics operations);
    bytes: every frame's magnitude columns from min_shc on, read once, and
    the band written once, in f32."""
    g = yaapt_geometry(num_samples, params)
    rows = batch * g["frames"]
    ops = rows * g["n_out"] * g["window"] * g["harm"]
    nbytes = rows * (g["columns"] - g["min_shc"] + g["n_out"]) * 4
    return bound_s(ops, nbytes)


# ---------------------------------------------------------------------------
# K2f / K2b: the chain denominator's forward-backward
# ---------------------------------------------------------------------------


def k2_bound_s(batch: int, frames: int, states: int, nnz: int) -> Tuple[float, float]:
    """(K2f, K2b) on a [batch, frames] minibatch over a den graph of
    ``states`` states whose transition matrix has ``nnz`` nonzeros. The
    forward makes one multiply-add per nonzero, row and frame; the backward
    two. Bytes: each input read once and each output written once: the
    per-state scores llf and lls, the start alphas, A's nonzeros (f32 values
    and 16-bit states) with S + 1 pointers, log_self and log_init in, the
    alphas [T + 1, B, S] out; the backward reads the final gradient, the
    alphas, llf, lls and the graph and writes both score gradients."""
    BTS = batch * frames * states
    a_bytes = nnz * (4 + 2) + (states + 1) * 4
    fwd = bound_s(2 * batch * frames * nnz,
                  4 * (2 * BTS + batch * states + 2 * states + (frames + 1) * batch * states)
                  + a_bytes)
    bwd = bound_s(4 * batch * frames * nnz,
                  4 * (batch * states + (frames + 1) * batch * states + 2 * BTS + 2 * states
                       + 2 * BTS) + a_bytes)
    return fwd, bwd


# ---------------------------------------------------------------------------
# K3f / K3b: the chain numerator's forward-backward
# ---------------------------------------------------------------------------


def k3_bound_s(frames: int, rows: Sequence[Tuple[int, int, int]]) -> Tuple[float, float]:
    """(K3f, K3b) on a minibatch of ``frames`` frames whose rows' numerator
    graphs have (states, live arcs, pdfs on live arcs) ``rows``. The
    forward makes one multiply-add in the log semiring per live arc, row and
    frame; the backward two. Bytes: the log-likelihood that each live arc
    gathers a frame, read once, and each row's alphas [frames + 1, states],
    which the forward writes and the backward reads; the backward also
    writes a frame's posterior for each pdf on the row's live arcs. The
    other posteriors are the zero fill's, a kernel of its own outside
    ``num_bwd``'s time. The arc tables, the start and final scores, m and
    the value (under 1% of these bytes at the chain cell's graphs) are left
    out."""
    arcs = sum(e for _, e, _ in rows)
    gathered_and_alphas = 4 * sum(frames * e + (frames + 1) * s for s, e, _ in rows)
    posteriors = 4 * frames * sum(p for _, _, p in rows)
    fwd = bound_s(2 * frames * arcs, gathered_and_alphas)
    bwd = bound_s(4 * frames * arcs, gathered_and_alphas + posteriors)
    return fwd, bwd


# ---------------------------------------------------------------------------
# TDNN-F extractor and HiFi-GAN generator
# ---------------------------------------------------------------------------


def _padding(kernels: Sequence[int], factors: Sequence[float]) -> int:
    pad, sub = 0.0, 1.0
    for k, s in zip(kernels, factors):
        pad += (k - 1) * sub
        sub *= s
    return int(pad)


def _frames_out(t: int, context: int, factor: float, dim: int) -> int:
    """Windows of ``context`` frames every ``factor`` frames over t frames of
    width ``dim`` (the 1.5 factor staggers windows over the flattened
    sequence)."""
    if float(factor).is_integer():
        return (t - context) // int(factor) + 1
    return (t * dim - context * dim) // int(dim * factor) + 1


def tdnnf_affines(net: Dict, num_samples: int, bottleneck_only: bool
                  ) -> Iterator[Tuple[int, int, int]]:
    """(input width, output width, frames) of every affine of the TDNN-F
    network on one utterance: up to the bottleneck's VQ input with
    ``bottleneck_only`` (what serving extracts), else through both heads."""
    ks, ss = net["kernel_size_list"], net["subsampling_factor_list"]
    ksa, ssa = net["kernel_size_list_after"], net["subsampling_factor_list_after"]
    h, b, pb = net["hidden_dim"], net["bottleneck_dim"], net["prefinal_bottleneck_dim"]
    t = (num_samples + 80) // 160 + 2 * (_padding(ks, ss) // 2)
    dim = net["num_mel_bins"]
    for i, (k, s) in enumerate(zip(ks, ss)):
        t = _frames_out(t, k, s, dim)
        last = i == len(ks) - 1
        yield dim * k, pb if last else b, t
        if last and bottleneck_only:
            return
        yield pb if last else b, h, t
        dim = h
    t += 2 * (_padding(ksa, ssa) // 2)
    for k, s in zip(ksa, ssa):
        t = _frames_out(t, k, s, h)
        yield h * k, b, t
        yield b, h, t
    for _ in range(2):  # the chain and xent prefinal layers and heads
        yield h, pb, t
        yield pb, h, t
        yield h, net["output_dim"], t


def tdnnf_frames(net: Dict, num_samples: int, bottleneck_only: bool) -> int:
    return list(tdnnf_affines(net, num_samples, bottleneck_only))[-1][2]


def tdnnf_flops(net: Dict, batch: int, num_samples: int, bottleneck_only: bool) -> float:
    """Forward operations of the TDNN-F's affines and the VQ's distances."""
    ops = sum(2 * i * o * t for i, o, t in tdnnf_affines(net, num_samples, bottleneck_only))
    if net.get("bottleneck") == "vq":
        t_bn = tdnnf_frames(net, num_samples, True)
        ops += 2 * net["prefinal_bottleneck_dim"] * net["codebook_size"] * t_bn
    return batch * ops


def hifigan_convs(gen: Dict, input_dim: int, frames: int) -> Iterator[Tuple[int, int, int, int]]:
    """(input channels, output channels, kernel, input frames) of every conv
    of the generator (a transposed conv's operations: one multiply-add per
    input frame, tap and channel pair)."""
    c0 = gen["upsample_initial_channel"]
    yield input_dim, c0, 7, frames
    t = frames
    for i, (u, k) in enumerate(zip(gen["upsample_rates"], gen["upsample_kernel_sizes"])):
        cin, ch = c0 // 2 ** i, c0 // 2 ** (i + 1)
        yield cin, ch, k, t
        t = (t - 1) * u - 2 * ((k - u) // 2) + k
        for rk, dil in zip(gen["resblock_kernel_sizes"], gen["resblock_dilation_sizes"]):
            for _ in range(2 * len(dil)):
                yield ch, ch, rk, t
    yield c0 // 2 ** len(gen["upsample_rates"]), 1, 7, t + 1


def hifigan_flops(gen: Dict, input_dim: int, batch: int, frames: int) -> float:
    return batch * sum(2 * ci * co * k * t for ci, co, k, t in
                       hifigan_convs(gen, input_dim, frames))


def convert_flops(model: Dict, batch: int, num_samples: int) -> float:
    """The anonymizer's ``convert`` on a padded [batch, num_samples] batch:
    the extractor to its bottleneck, then the generator over the bottleneck
    frames with the F0 and the target's one-hot."""
    net, gen = model["asrbn"], model["generator"]
    t_bn = tdnnf_frames(net, num_samples, True)
    input_dim = net["prefinal_bottleneck_dim"] + 1 + model["num_speakers"]
    return (tdnnf_flops(net, batch, num_samples, True)
            + hifigan_flops(gen, input_dim, batch, t_bn))


def train_step_flops(net: Dict, lengths: List[int]) -> float:
    """One training step's network forward and backward (the backward twice
    the forward) over utterances of ``lengths`` samples."""
    return 3 * sum(tdnnf_flops(net, 1, n, False) for n in lengths)
