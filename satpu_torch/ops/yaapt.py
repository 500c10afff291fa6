"""YAAPT fundamental-frequency tracker, batched PyTorch (port of ``satpu.ops.yaapt``).

The whole tracker runs on the device of its input, batched over utterances:

- the 50-1500 Hz band-pass (the exact truncated FIR of the lowpass/highpass
  biquad cascade) as one FFT convolution,
- NLFER, the SHC spectral track and both NCCF time tracks for ALL frames as
  dense batched tensor ops (``torch.fft`` spectra and correlations); the SHC
  band is the hand-written CUDA kernel ``csrc/shc.cu`` (``shc_band``),
- the two dynamic programs (dynamic5 over the compacted voiced frames and
  the final candidate Viterbi) as batched sequential Viterbi passes with
  identity-transition padding, so compaction keeps a static shape; each is
  one launch of the hand-written CUDA kernel ``csrc/viterbi.cu``
  (``viterbi_path``).

Everything stays in full f32: single-pass bf16 (and so TF32) flips octaves.
The reference quirks that ``satpu.ops.yaapt`` reproduces are reproduced
here too (single NCCF candidate per frame, linear resampling of the
compacted nonzero spectral track, spec_pitch[0:2] overwritten with [2:4]).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..utils import cuda_build
from ..utils.trace import span
from . import device_array

INF = 1e30

DEFAULTS = dict(
    sr=16000.0, frame_length=35.0, tda_frame_length=35.0, frame_space=10.0,
    f0_min=60.0, f0_max=400.0, fft_length=8192.0, bp_low=50.0, bp_high=1500.0,
    nlfer_thresh1=0.75, nlfer_thresh2=0.1, shc_numharms=3.0, shc_window=40.0,
    shc_maxpeaks=4.0, shc_pwidth=50.0, shc_thresh1=5.0, shc_thresh2=1.25,
    f0_double=150.0, f0_half=150.0, dp5_k1=11.0, nccf_thresh1=0.3,
    nccf_thresh2=0.9, nccf_maxcands=3.0, nccf_pwidth=5.0, merit_boost=0.20,
    merit_pivot=0.99, merit_extra=0.4, median_value=7.0, dp_w1=0.15, dp_w2=0.5,
    dp_w3=0.1, dp_w4=0.9, spec_pitch_min_std=0.05,
)


# ---------------------------------------------------------------------------
# Band-pass
# ---------------------------------------------------------------------------


def _biquad_coeffs(fs: float, freq: float, kind: str, Q: float = 0.707):
    w0 = 2.0 * math.pi * freq / fs
    alpha = math.sin(w0) / (2.0 * Q)
    cos_w0 = math.cos(w0)
    if kind == "lowpass":
        b = np.array([(1 - cos_w0) / 2, 1 - cos_w0, (1 - cos_w0) / 2])
    else:  # highpass
        b = np.array([(1 + cos_w0) / 2, -(1 + cos_w0), (1 + cos_w0) / 2])
    a = np.array([1 + alpha, -2 * cos_w0, 1 - alpha])
    return (b / a[0]).astype(np.float64), (a / a[0]).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _bandpass_fir(fs: float, bp_low: float, bp_high: float, n_taps: int = 3072) -> np.ndarray:
    """Impulse response of the lowpass(bp_high) -> highpass(bp_low) biquad
    cascade, truncated at n_taps (the slowest pole has decayed to ~1e-13)."""
    bl, al = _biquad_coeffs(fs, bp_high, "lowpass")
    bh, ah = _biquad_coeffs(fs, bp_low, "highpass")
    x = np.zeros(n_taps)
    x[0] = 1.0

    def lfilt(b, a, u):
        y = np.zeros_like(u)
        for t in range(len(u)):
            acc = b[0] * u[t]
            if t >= 1:
                acc += b[1] * u[t - 1] - a[1] * y[t - 1]
            if t >= 2:
                acc += b[2] * u[t - 2] - a[2] * y[t - 2]
            y[t] = acc
        return y

    return lfilt(bh, ah, lfilt(bl, al, x)).astype(np.float32)


def bandpass(x: torch.Tensor, fs: float, bp_low: float, bp_high: float) -> torch.Tensor:
    """Causal FIR band-pass of [..., T] signals as one FFT convolution."""
    h = device_array(_bandpass_fir, (fs, bp_low, bp_high), x.device)
    T = x.shape[-1]
    n = 1 << (T + h.numel() - 2).bit_length()  # >= T + taps - 1: linear, not circular
    y = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(h, n=n), n=n)
    return y[..., :T]


# ---------------------------------------------------------------------------
# Small helpers (batched over the leading axis)
# ---------------------------------------------------------------------------


def frame_strided(x: torch.Tensor, n_frames: int, size: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., n_frames, size] frames starting every ``hop`` samples."""
    return x.unfold(-1, size, hop)[..., :n_frames, :]


def medfilt(x: torch.Tensor, k: int, valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero-padded median filter over the last axis of [B, T]; entries at
    index >= valid_len[b] count as zero. ``k`` must be odd: torch.median
    returns the lower middle, which equals the median only then."""
    if k <= 1:
        return x
    if k % 2 == 0:
        raise ValueError(f"medfilt needs an odd window, got {k}")
    if valid_len is not None:
        t = torch.arange(x.shape[-1], device=x.device)
        x = torch.where(t < valid_len[:, None], x, 0.0)
    pad = k // 2
    return F.pad(x, (pad, pad)).unfold(-1, k, 1).median(dim=-1).values


def compact_by_mask(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable order moving the True entries of each row of [B, T] to the
    front: (num_valid [B], gather order [B, T])."""
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    return mask.sum(dim=-1), order


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def masked_std(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unbiased (n - 1) standard deviation over the True entries of each row."""
    m = mask.to(x.dtype)
    n = m.sum(-1)
    mu = (x * m).sum(-1) / torch.clamp(n, min=1.0)
    var = (((x - mu[:, None]) ** 2) * m).sum(-1) / torch.clamp(n - 1, min=1.0)
    return torch.sqrt(var)


def linear_resample_compact(x: torch.Tensor, num_valid: torch.Tensor, out_len: int) -> torch.Tensor:
    """Per row, F.interpolate(mode='linear', align_corners=False) of
    x[b, :num_valid[b]] to length out_len."""
    nv = num_valid.to(torch.float32)[:, None]
    scale = nv / out_len
    pos = (torch.arange(out_len, device=x.device, dtype=torch.float32) + 0.5) * scale - 0.5
    pos = torch.minimum(torch.clamp(pos, min=0.0), torch.clamp(nv - 1.0, min=0.0))
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(num_valid[:, None] - 1, min=0))
    frac = pos - lo.to(torch.float32)
    return x.gather(1, lo) * (1.0 - frac) + x.gather(1, hi) * frac


def viterbi_path_plain(local: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Plain version of ``viterbi_path``: a loop over frames. Ties go to the
    LAST minimum like the reference: torch.min/argmin return the first, so
    the DP runs in flipped candidate coordinates (and a NaN cost wins, the
    last NaN over the others)."""
    B, C, T = local.shape
    lf = local.flip(1).permute(2, 0, 1).contiguous()                # [T, B, C]
    tf = trans.flip(1).flip(2).permute(3, 0, 1, 2).contiguous()     # [T, B, C, C]
    pcost = lf[0]
    preds = []
    for t in range(1, T):
        val, k = (pcost[:, None, :] + tf[t]).min(dim=-1)
        pcost = val + lf[t]
        preds.append(k)
    cur = pcost.argmin(dim=-1, keepdim=True)
    path = [cur]
    for k in reversed(preds):
        cur = k.gather(1, cur)
        path.append(cur)
    return (C - 1) - torch.cat(path[::-1], dim=1)


def viterbi_path(local: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Lowest-cost candidate path per row, sequential over frames.

    local [B, C, T]; trans [B, C, C, T] with trans[b, next, prev, t]; both
    f32, T >= 1. Returns [B, T] int64 candidate indices. Ties go to the LAST
    minimum like the reference.

    On a CUDA tensor this launches the kernel of ``csrc/viterbi.cu`` (K4: the
    forward and the backtrace in one launch, counted in ``k4.launches``),
    whose path is the plain version's bit for bit; it takes up to
    ``VITERBI_MAX_CANDIDATES`` candidates (more raise ValueError), reads both
    inputs through their strides (a transposed view is not copied) and runs
    on their card, whichever device is current. C = 4 and 6 run unrolled
    instantiations, any other C the generic one. On a CPU tensor it computes
    the plain version, at any C. Any other device raises.
    """
    dev = cuda_build.device_of("viterbi_path", local, trans)
    if local.ndim != 3 or trans.ndim != 4:
        raise ValueError(f"viterbi_path wants local [B, C, T] and trans [B, C, C, T], got"
                         f" {tuple(local.shape)} and {tuple(trans.shape)}")
    B, C, T = local.shape
    if tuple(trans.shape) != (B, C, C, T) or C < 1 or T < 1:
        raise ValueError(f"viterbi_path wants trans [B, C, C, T] = {(B, C, C, T)} with C, T >= 1,"
                         f" got {tuple(trans.shape)}")
    if local.dtype != torch.float32 or trans.dtype != torch.float32:
        raise TypeError(f"viterbi_path wants float32, got {local.dtype} and {trans.dtype}")
    if dev.type == "cpu":
        return viterbi_path_plain(local, trans)
    if C > VITERBI_MAX_CANDIDATES:
        raise ValueError(f"the Viterbi kernel takes 1..{VITERBI_MAX_CANDIDATES} candidates,"
                         f" got {C}")
    path = torch.empty((B, T), device=dev, dtype=torch.int64)
    if B == 0:
        return path
    lib = cuda_build.load("viterbi")
    scratch = lib.satpu_viterbi_scratch_bytes(C, T)
    back = torch.empty((B, scratch), device=dev, dtype=torch.uint8) if scratch else None
    cuda_build.launch(lib.satpu_viterbi_path, local.data_ptr(), *local.stride(), trans.data_ptr(),
                      *trans.stride(), path.data_ptr(), back.data_ptr() if scratch else None,
                      B, C, T, device=dev, counter="k4.launches")
    return path


VITERBI_MAX_CANDIDATES = 16  # kMaxC of csrc/viterbi.cu


@torch.library.custom_op("satpu_torch::viterbi_path", mutates_args=(),
                         device_types=("cpu", "cuda"))
def viterbi_path_op(local: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``viterbi_path`` as the registered op ``torch.ops.satpu_torch.viterbi_path``
    (K4 on a CUDA tensor, the plain version on a CPU one), which both DPs
    call, so ``torch.export`` records one op where it would unroll the plain
    loop, and the exported program launches K4 on the card."""
    return viterbi_path(local, trans)


@viterbi_path_op.register_fake
def _viterbi_path_fake(local, trans):
    return local.new_empty((local.shape[0], local.shape[2]), dtype=torch.int64)


# ---------------------------------------------------------------------------
# NLFER
# ---------------------------------------------------------------------------


def _hann_window(n: int) -> np.ndarray:
    return np.hanning(n + 2)[1:-1].astype(np.float32)


def _kaiser_window(n: int) -> np.ndarray:
    return np.kaiser(n + 1, 0.5)[:-1].astype(np.float32)


def nlfer(filtered: torch.Tensor, frame_size: int, frame_jump: int, nfft: int,
          p: Dict[str, float]):
    """filtered [B, S] -> (energy [B, F], vuv [B, F], F)."""
    size = filtered.shape[-1]
    fs = p["sr"]
    n_min = int(np.round(p["f0_min"] * 2 / fs * nfft))
    n_max = int(np.round(p["f0_max"] / fs * nfft))
    n_frames = len(range(frame_size // 2, size - frame_size // 2, frame_jump))
    frames = (frame_strided(filtered, n_frames, frame_size, frame_jump)
              * device_array(_hann_window, (frame_size,), filtered.device))
    mag = torch.fft.rfft(frames, n=nfft)[..., n_min - 1:n_max].abs()
    frame_energy = mag.sum(-1)
    energy = frame_energy / frame_energy.mean(-1, keepdim=True)
    vuv = energy > p["nlfer_thresh1"]
    return energy, vuv, n_frames


# ---------------------------------------------------------------------------
# Spectral track: SHC (kernel K1) + peaks + dynamic5
# ---------------------------------------------------------------------------


def shc_band_plain(mag: torch.Tensor, min_shc: int, n_out: int, n_harm: int,
                   window_length: int) -> torch.Tensor:
    """Plain version of ``shc_band``: the gather formulation
    sum_j prod_h mag[:, (min_shc+i)(h+1) + j], materializing [F, I, H, J]."""
    i_idx = torch.arange(n_out, device=mag.device)
    h_idx = torch.arange(n_harm, device=mag.device)
    j_idx = torch.arange(window_length, device=mag.device)
    gather = ((min_shc + i_idx)[:, None, None] * (h_idx + 1)[None, :, None]
              + j_idx[None, None, :])  # [I, H, J]
    g = mag[:, gather.reshape(-1)].reshape((mag.shape[0],) + tuple(gather.shape))
    return g.prod(dim=2).sum(dim=2)


def shc_band(mag: torch.Tensor, min_shc: int, n_out: int, n_harm: int,
             window_length: int) -> torch.Tensor:
    """SHC band [F, n_out] of the padded magnitude ``mag`` [F, M] (f32).

    On a CUDA tensor this launches the kernel of ``csrc/shc.cu`` (and counts
    the launch in the counter ``k1.launches``); on a CPU tensor it computes the
    plain version, at any harmonic count. Any other device raises. The
    kernel runs on ``mag``'s card, whichever device is current. The
    kernel takes 1 to ``SHC_MAX_HARMONICS`` harmonics (a CUDA call with more
    raises ValueError); (n_harm, window_length) = (4, 21) runs
    its unrolled instantiation, any other its generic one
    (``shc_instantiation``); a geometry whose staged frames do not fit a
    block's shared memory raises RuntimeError. A non-contiguous ``mag`` is
    copied to a contiguous one; a storage offset needs no alignment beyond a
    float's (the kernel then copies ``mag`` in 4-byte pieces, else in 16-byte
    ones).
    """
    dev = cuda_build.device_of("shc_band", mag)
    if mag.ndim != 2:
        raise ValueError(f"shc_band wants mag [F, M], got {tuple(mag.shape)}")
    n_frames, M = mag.shape
    deepest = (min_shc + n_out - 1) * n_harm + window_length - 1
    if deepest >= M:
        raise ValueError(f"shc_band reads column {deepest} of a {M}-column mag")
    if dev.type == "cpu":
        return shc_band_plain(mag, min_shc, n_out, n_harm, window_length)
    if not (1 <= n_harm <= SHC_MAX_HARMONICS and min_shc >= 0 and n_out >= 1
            and window_length >= 1):
        raise ValueError(f"the SHC kernel takes 1..{SHC_MAX_HARMONICS} harmonics, min_shc >= 0"
                         f" and n_out, window_length >= 1; got n_harm={n_harm},"
                         f" min_shc={min_shc}, n_out={n_out}, window_length={window_length}")
    if mag.dtype != torch.float32:
        raise TypeError(f"shc_band wants float32, got {mag.dtype}")
    mag = mag.contiguous()
    out = torch.empty((n_frames, n_out), device=dev, dtype=torch.float32)
    if n_frames == 0:
        return out
    cuda_build.launch(cuda_build.load("shc").satpu_shc_band, mag.data_ptr(), out.data_ptr(),
                      n_frames, M, min_shc, n_out, n_harm, window_length, device=dev,
                      counter="k1.launches")
    return out


SHC_MAX_HARMONICS = 6  # kMaxH of csrc/shc.cu


@torch.library.custom_op("satpu_torch::shc_band", mutates_args=(), device_types=("cpu", "cuda"))
def shc_band_op(mag: torch.Tensor, min_shc: int, n_out: int, n_harm: int,
                window_length: int) -> torch.Tensor:
    """``shc_band`` as the registered op ``torch.ops.satpu_torch.shc_band``
    (the kernel on a CUDA tensor, the plain version on a CPU one), which
    ``get_f0`` calls: ``torch.export`` records the op where it cannot trace
    the kernel's raw-pointer launch, and a program exported with it loads
    wherever this module has been imported."""
    return shc_band(mag, min_shc, n_out, n_harm, window_length)


@shc_band_op.register_fake
def _shc_band_fake(mag, min_shc, n_out, n_harm, window_length):
    return mag.new_empty((mag.shape[0], n_out), dtype=torch.float32)


def shc_instantiation(n_harm: int, window_length: int) -> str:
    """The instantiation of K1 that ``shc_band`` runs on the card for
    (n_harm, window_length): "fixed" (the unrolled one) or "generic". Needs
    the kernel's library, so the CUDA toolkit."""
    return "fixed" if cuda_build.load("shc").satpu_shc_fixed(n_harm, window_length) else "generic"


def shc_params(nfft: int, p: Dict[str, float]) -> Dict[str, int]:
    """Static SHC geometry: window, candidate band and harmonic count."""
    delta = p["sr"] / nfft
    window_length = int(math.floor(p["shc_window"] / delta))
    if window_length % 2 == 0:
        window_length += 1
    max_shc = int(math.floor((p["f0_max"] + p["shc_pwidth"] * 2) / delta))
    min_shc = int(math.ceil(p["f0_min"] / delta))
    n_harm = int(p["shc_numharms"]) + 1
    n_out = max_shc - min_shc + 1
    top = (min_shc + n_out - 1) * n_harm + window_length  # padded columns read
    return dict(window_length=window_length, half_window=window_length // 2,
                max_shc=max_shc, min_shc=min_shc, n_harm=n_harm, n_out=n_out,
                top_bin=top - window_length // 2)


def shc_magnitude(filtered_nl: torch.Tensor, n_frames: int, frame_size: int,
                  frame_jump: int, nfft: int, p: Dict[str, float]) -> torch.Tensor:
    """The SHC kernel's input: the half-window-padded banded magnitude
    spectrum of every frame, [B, S] -> [B * n_frames, M]."""
    g = shc_params(nfft, p)
    nframe_size = frame_size * 2
    B, size = filtered_nl.shape
    pad_to = nframe_size + (n_frames - 1) * frame_jump
    data = F.pad(filtered_nl, (0, max(0, pad_to - size)))
    frames = (frame_strided(data, n_frames, nframe_size, frame_jump)
              * device_array(_kaiser_window, (nframe_size,), data.device))
    frames = frames - frames.mean(-1, keepdim=True)
    # the reference prepends half_window zero bins: padded column c reads
    # rfft bin c - half_window
    mag = torch.fft.rfft(frames, n=nfft)[..., :g["top_bin"]].abs()
    return F.pad(mag, (g["half_window"], 0)).reshape(B * n_frames, -1)


def shc_all_frames(filtered_nl: torch.Tensor, n_frames: int, frame_size: int,
                   frame_jump: int, nfft: int, p: Dict[str, float]) -> torch.Tensor:
    """SHC spectra for every frame: [B, S] -> [B, n_frames, max_SHC]."""
    g = shc_params(nfft, p)
    mag = shc_magnitude(filtered_nl, n_frames, frame_size, frame_jump, nfft, p)
    band = shc_band_op(mag, g["min_shc"], g["n_out"], g["n_harm"], g["window_length"])
    shc = torch.zeros((mag.shape[0], g["max_shc"]), device=mag.device, dtype=torch.float32)
    shc[:, g["min_shc"] - 1:g["max_shc"]] = band
    return shc.reshape(filtered_nl.shape[0], n_frames, g["max_shc"])


def peaks_frame(data: torch.Tensor, delta: float, maxpeaks: int, p: Dict[str, float]):
    """The reference peaks() for every row of data [N, L]: (pitch, merit)
    candidates [N, maxpeaks]."""
    thresh1, thresh2 = p["shc_thresh1"], p["shc_thresh2"]
    eps = 1e-14
    width = int(math.floor(p["shc_pwidth"] / delta))
    if width % 2 == 0:
        width += 1
    center = int(math.ceil(width / 2))
    L = data.shape[-1]
    min_lag = max(1, int(math.floor(p["f0_min"] / delta - center)))
    max_lag = min(L - width, int(math.floor(p["f0_max"] / delta + center)))

    max_data = data[:, min_lag:max_lag + 1].amax(-1, keepdim=True)
    data = torch.where(max_data > eps, data / max_data, data)
    avg_data = data[:, min_lag:max_lag + 1].mean(-1, keepdim=True)

    # candidate positions n in [lo, hi)
    lo, hi = min_lag + center + 1, max_lag - center + 1
    d_n = data[:, lo:hi]
    is_peak = ((d_n > data[:, lo - 1:hi - 1]) & (d_n > data[:, lo + 1:hi + 1])
               & (d_n > thresh2 * avg_data))
    # centered-argmax check over [n-center, n+center]: strict max vs the
    # left window, >= max of the right one (argmax returns the first)
    lm = data.unfold(-1, center, 1).amax(-1)  # lm[t] = max data[t:t+center]
    left_max = lm[:, lo - center:hi - center]
    right_max = lm[:, lo + 1:hi + 1]
    valid = is_peak & (d_n > left_max) & (d_n >= right_max)

    # top-maxpeaks by merit, ties by lag order: iterative first-argmax + mask
    m = torch.where(valid, d_n, -1.0)
    sel = []
    for _ in range(maxpeaks):
        a = m.argmax(-1, keepdim=True)
        sel.append(a)
        m = m.scatter(-1, a, -math.inf)
    sel = torch.cat(sel, dim=-1)
    sel_valid = valid.gather(-1, sel)
    pos = (sel + lo).to(torch.float32)
    pitch = torch.where(sel_valid, pos * delta, 0.0)
    merit = torch.where(sel_valid, d_n.gather(-1, sel), 0.0)
    numpeaks = torch.clamp(valid.sum(-1), max=maxpeaks)

    # the reference's extra half/double candidates
    slots = torch.arange(maxpeaks, device=data.device)
    pitch_f, merit_f, n_f = pitch, merit, numpeaks
    for kind in ("double", "half"):
        head = pitch_f[:, 0]
        if kind == "double":
            cond, value = head > p["f0_double"], head / 2.0
        else:
            cond, value = head < p["f0_half"], head * 2.0
        new_n = torch.clamp(n_f + 1, max=maxpeaks)
        hit = cond[:, None] & (slots[None, :] == (new_n - 1)[:, None])
        pitch_f = torch.where(hit, value[:, None], pitch_f)
        merit_f = torch.where(hit, p["merit_extra"], merit_f)
        n_f = torch.where(cond, new_n, n_f)
    fill = slots[None, :] >= n_f[:, None]
    pitch_f = torch.where(fill, pitch_f[:, :1], pitch_f)
    merit_f = torch.where(fill, merit_f[:, :1], merit_f)

    avg = avg_data[:, 0]
    step2_fail = merit.amax(-1) / avg < thresh1
    avg_fail = avg > 1.0 / thresh1
    no_result = (avg_fail | step2_fail | (numpeaks == 0))[:, None]
    return (torch.where(no_result, 0.0, pitch_f),
            torch.where(no_result, 1.0, merit_f))


def spec_track(filtered_nl: torch.Tensor, energy, vuv, n_frames: int,
               frame_size: int, frame_jump: int, nfft: int, p: Dict[str, float]):
    """-> (spec_pitch [B, F], pitch_std [B])."""
    fs = p["sr"]
    delta = fs / nfft
    maxpeaks = int(p["shc_maxpeaks"])
    B = filtered_nl.shape[0]
    dev = filtered_nl.device
    with span("yaapt.shc"):
        shc = shc_all_frames(filtered_nl, n_frames, frame_size, frame_jump, nfft, p)
    with span("yaapt.peaks"):
        pk, mr = peaks_frame(shc.reshape(B * n_frames, -1), delta, maxpeaks, p)
    pk = pk.reshape(B, n_frames, maxpeaks)
    mr = mr.reshape(B, n_frames, maxpeaks)
    cand_pitch = torch.where(vuv[..., None], pk, 0.0).transpose(1, 2)  # [B, C, F]
    cand_merit = torch.where(vuv[..., None], mr, 1.0).transpose(1, 2)

    voiced_mask = cand_pitch[:, 0, :] > 0.0
    num_voiced, order = compact_by_mask(voiced_mask)
    idx = order[:, None, :].expand(-1, maxpeaks, -1)
    vp = cand_pitch.gather(2, idx)
    vm = cand_merit.gather(2, idx)
    t_ar = torch.arange(n_frames, device=dev)
    valid = t_ar[None, :] < num_voiced[:, None]

    avg_voiced = masked_mean(vp[:, 0], valid)
    std_voiced = masked_std(vp[:, 0], valid)

    delta1 = torch.abs(vp - 0.8 * avg_voiced[:, None, None]) * (3.0 - vm)
    delta1 = torch.where(valid[:, None, :], delta1, INF)
    index = delta1.argmin(dim=1, keepdim=True)  # [B, 1, F]
    index_oh = torch.arange(maxpeaks, device=dev)[None, :, None] == index
    peak_minmrt = vp.gather(1, index)[:, 0]
    merit_minmrt = vm.gather(1, index)[:, 0]
    k_med = max(1, int(p["median_value"]) - 2)
    peak_minmrt_f = medfilt(peak_minmrt, k_med, valid_len=num_voiced)
    new_peak = torch.where(valid, peak_minmrt_f, peak_minmrt)
    vp = torch.where(index_oh, new_peak[:, None, :], vp)
    vm = torch.where(index_oh, merit_minmrt[:, None, :], vm)

    # k1 = dp5_k1 * std/avg is data-dependent, one weight per utterance
    weight_trans = p["dp5_k1"] * std_voiced / avg_voiced
    with span("yaapt.dynamic5"):
        voiced_pitch = _dynamic5_traced(vp, vm, num_voiced, weight_trans, p["f0_min"])
    voiced_pitch = medfilt(voiced_pitch, k_med, valid_len=num_voiced)
    # fallback when too few voiced candidates
    voiced_pitch = torch.where((num_voiced <= 2)[:, None], 150.0, voiced_pitch)

    pitch_avg = masked_mean(voiced_pitch, valid)
    pitch_std = torch.maximum(masked_std(voiced_pitch, valid),
                              pitch_avg * p["spec_pitch_min_std"])

    spec_pitch = torch.zeros((B, n_frames), device=dev, dtype=torch.float32)
    spec_pitch = spec_pitch.scatter(1, order, torch.where(valid, voiced_pitch, 0.0))
    spec_pitch = torch.where(voiced_mask, spec_pitch, 0.0)
    half = (pitch_avg / 2)
    spec_pitch[:, 0] = torch.where(spec_pitch[:, 0] < half, pitch_avg, spec_pitch[:, 0])
    spec_pitch[:, -1] = torch.where(spec_pitch[:, -1] < half, pitch_avg, spec_pitch[:, -1])

    # linear RESAMPLING of the nonzero entries
    n_nz, nz_order = compact_by_mask(spec_pitch != 0)
    nz_vals = spec_pitch.gather(1, nz_order)
    nz_vals = torch.where(t_ar[None, :] < n_nz[:, None], nz_vals, 0.0)
    spec_pitch = linear_resample_compact(nz_vals, n_nz, n_frames)
    spec_pitch[:, 0] = spec_pitch[:, 2]
    spec_pitch[:, 1] = spec_pitch[:, 3]
    return spec_pitch, pitch_std


def _dynamic5_traced(pitch_array, merit_array, num_valid, k1, f0_min):
    """dynamic5 over compacted candidates [B, C, T]; frames at or past
    num_valid[b] get an identity transition and zero local cost."""
    B, C, T = pitch_array.shape
    dev = pitch_array.device
    local = 1.0 - merit_array
    d = torch.abs(pitch_array[:, None, :, 1:] - pitch_array[:, :, None, :-1]) / f0_min
    d = 0.05 * d + d ** 2
    trans = torch.zeros((B, C, C, T), device=dev, dtype=torch.float32)
    trans[..., 1:] = k1[:, None, None, None] * d
    tmask = torch.arange(T, device=dev)[None, :] < num_valid[:, None]  # [B, T]
    local = torch.where(tmask[:, None, :], local, 0.0)
    pad_trans = torch.where(torch.eye(C, device=dev, dtype=torch.bool), 0.0, INF)
    trans = torch.where(tmask[:, None, None, :], trans, pad_trans[None, :, :, None])
    path = viterbi_path_op(local, trans)
    return pitch_array.gather(1, path[:, None, :])[:, 0]


# ---------------------------------------------------------------------------
# NCCF time track
# ---------------------------------------------------------------------------


def _banded_corr(a: torch.Tensor, b: torch.Tensor, nfft: int, lag_lo: int,
                 lag_hi: int) -> torch.Tensor:
    """corr[k] = sum_t a[t] * b[t+k] for k in [lag_lo, lag_hi); nfft must be
    >= len + lag_hi so the circular correlation does not wrap."""
    A = torch.fft.rfft(a, n=nfft)
    Bf = torch.fft.rfft(b, n=nfft)
    return torch.fft.irfft(torch.conj(A) * Bf, n=nfft)[..., lag_lo:lag_hi]


def time_track(filtered: torch.Tensor, spec_pitch, pitch_std, n_frames_total: int,
               frame_jump: int, signal_len: int, p: Dict[str, float]):
    """filtered [R, S], spec_pitch [R, F], pitch_std [R] -> (time_pitch,
    time_merit) [R, maxcands, F]."""
    fs = p["sr"]
    dev = filtered.device
    R = filtered.shape[0]
    tda_frame_length = int(p["tda_frame_length"] * fs / 1000)
    tda_noverlap = tda_frame_length - frame_jump
    tda_nframes = int((signal_len - tda_noverlap) / frame_jump)
    tda_nframes = min(tda_nframes, n_frames_total)
    spec_pitch_t = spec_pitch[:, :tda_nframes]

    merit_boost = p["merit_boost"]
    maxcands = int(p["nccf_maxcands"])
    freq_thresh = (5.0 * pitch_std)[:, None]

    lo = torch.clamp(spec_pitch_t - 2.0 * pitch_std[:, None], min=p["f0_min"])
    hi = torch.clamp(spec_pitch_t + 2.0 * pitch_std[:, None], max=p["f0_max"])
    pw_half = int(math.floor(p["nccf_pwidth"] / 2.0))
    lag_min_f = torch.floor(fs / hi).to(torch.int64) - pw_half  # [R, F]
    lag_max_f = torch.floor(fs / lo).to(torch.int64) + pw_half

    glag_min = int(math.floor(fs / p["f0_max"])) - pw_half
    glag_max = int(math.floor(fs / p["f0_min"])) + pw_half

    x = frame_strided(filtered, tda_nframes, tda_frame_length, frame_jump)
    x = x - x.mean(-1, keepdim=True)  # [R, F, L]
    data_len = tda_frame_length
    ks = torch.arange(glag_min, glag_max, device=dev)  # lag values
    K = ks.numel()
    sq = x ** 2
    cs_sq = torch.cumsum(sq, dim=-1)

    # numerator(k, N) = sum_{t<N} x[t] x[t+k] and sum_{t<N} x[t+k]^2 at the
    # per-frame window length N = L - lag_max(frame): correlations of the
    # N-masked frame (and mask) against the frame (and its square)
    Ns = torch.clamp(data_len - lag_max_f, min=1)
    t_j = torch.arange(data_len, device=dev)
    mask = (t_j < Ns[..., None]).to(x.dtype)
    nfft_corr = 1 << int(np.ceil(np.log2(data_len + glag_max + 1)))
    num = _banded_corr(x * mask, x, nfft_corr, glag_min, glag_max)
    sum_sq_shift = _banded_corr(mask, sq, nfft_corr, glag_min, glag_max)
    n_idx = torch.clamp(Ns - 1, 0, data_len - 1)
    p_energy = cs_sq.gather(-1, n_idx[..., None])
    phi = num / torch.sqrt(torch.clamp(sum_sq_shift * p_energy, min=1e-30))  # [R, F, K]

    in_range = (ks >= lag_min_f[..., None]) & (ks < lag_max_f[..., None])
    phi_m = torch.where(in_range, phi, 0.0)

    # cmp_rate: only the FIRST peak in [lag_min+center, lag_max-center] counts
    center = pw_half
    left = F.pad(phi_m, (1, 0))[..., :-1]
    right = F.pad(phi_m, (0, 1))[..., 1:]
    peak_band = (ks >= lag_min_f[..., None] + center) & (ks <= lag_max_f[..., None] - center)
    is_peak = (phi_m > left) & (phi_m > right) & (phi_m > p["nccf_thresh1"]) & peak_band
    any_peak = is_peak.any(-1)
    first_peak = is_peak.to(torch.int32).argmax(-1, keepdim=True)  # first True
    first_lag = first_peak[..., 0] + glag_min
    phi_max = phi_m.amax(-1)

    # centered-argmax check at the first peak; edge padding reproduces the
    # reference's index clipping
    d_peak = phi_m.gather(-1, first_peak)[..., 0]
    pad_l = torch.cat([phi_m[..., :1].expand(-1, -1, center), phi_m], dim=-1)
    lmax = pad_l.unfold(-1, center, 1).amax(-1)[..., :K]
    pad_r = torch.cat([phi_m, phi_m[..., -1:].expand(-1, -1, center)], dim=-1)
    rmax = pad_r.unfold(-1, center, 1).amax(-1)[..., 1:K + 1]
    left_max = lmax.gather(-1, first_peak)[..., 0]
    right_max = rmax.gather(-1, first_peak)[..., 0]
    centered = (d_peak > left_max) & (d_peak >= right_max)

    strong = phi_max > p["nccf_thresh2"]
    use = any_peak & (strong | centered)
    pitch0 = torch.where(use, fs / (first_lag.to(torch.float32) + 1.0), 0.0)
    merit0 = torch.where(use, d_peak, 0.0)
    merit0 = torch.where(merit0 > 1.0, 1.0, merit0)

    time_pitch = torch.zeros((R, maxcands, tda_nframes), device=dev, dtype=torch.float32)
    time_merit = torch.zeros_like(time_pitch)
    time_pitch[:, 0] = pitch0
    time_merit[:, 0] = merit0

    diff = torch.abs(time_pitch - spec_pitch_t[:, None, :])
    match1 = diff < freq_thresh[..., None]
    match = (1.0 - diff / freq_thresh[..., None]) * match1
    time_merit = (1.0 + merit_boost) * time_merit * match
    pad = n_frames_total - tda_nframes
    if pad > 0:
        time_pitch = F.pad(time_pitch, (0, pad))
        time_merit = F.pad(time_merit, (0, pad))
    return time_pitch, time_merit


# ---------------------------------------------------------------------------
# refine + final dynamic
# ---------------------------------------------------------------------------


def refine(tp1, tm1, tp2, tm2, spec_pitch, energy, vuv, p: Dict[str, float]):
    """Merge the two time tracks and the spectral track into [B, 6, F]
    candidate (pitch, merit) arrays for the final Viterbi."""
    time_pitch = torch.cat([tp1, tp2], dim=1)
    time_merit = torch.cat([tm1, tm2], dim=1)
    maxcands = time_pitch.shape[1]

    idx = torch.argsort(-time_merit, dim=1, stable=True)
    time_merit = torch.sort(time_merit, dim=1).values.flip(1)
    time_pitch = time_pitch.gather(1, idx)

    best_pitch = medfilt(time_pitch[:, 0], int(p["median_value"])) * vuv

    idx1 = energy <= p["nlfer_thresh2"]
    idx2 = (energy > p["nlfer_thresh2"]) & (time_pitch[:, 0] > 0)
    idx3 = (energy > p["nlfer_thresh2"]) & (time_pitch[:, 0] <= 0)
    merit_mat = torch.zeros_like(time_pitch, dtype=torch.bool)
    merit_mat[:, 1:maxcands - 1] = (time_pitch[:, 1:maxcands - 1] == 0) & idx2[:, None]

    time_pitch = torch.where(idx1[:, None], 0.0, time_pitch)
    time_merit = torch.where(idx1[:, None], p["merit_pivot"], time_merit)

    last = maxcands - 1
    time_pitch[:, last] = torch.where(idx2, 0.0, time_pitch[:, last])
    time_merit[:, last] = torch.where(idx2, 1.0 - time_merit[:, 0], time_merit[:, last])
    time_merit = torch.where(merit_mat, 0.0, time_merit)

    time_pitch[:, 0] = torch.where(idx3, spec_pitch, time_pitch[:, 0])
    time_merit[:, 0] = torch.where(idx3, torch.clamp(energy / 2.0, max=1.0), time_merit[:, 0])
    rest = (torch.arange(maxcands, device=energy.device)[None, :, None] >= 1) & idx3[:, None, :]
    time_pitch = torch.where(rest, 0.0, time_pitch)
    time_merit = torch.where(rest, 1.0 - time_merit[:, :1], time_merit)

    time_pitch[:, maxcands - 2] = best_pitch
    time_merit[:, maxcands - 2] = torch.where(
        best_pitch > 0.0, time_merit[:, 0], 1.0 - torch.clamp(energy / 2.0, max=1.0))

    time_pitch[:, maxcands - 3] = spec_pitch
    time_merit[:, maxcands - 3] = energy / 5.0
    return time_pitch, time_merit


def dynamic_final(ref_pitch, ref_merit, energy, p: Dict[str, float]):
    """Final candidate Viterbi: [B, C, F] candidates -> F0 [B, F]."""
    B, C, T = ref_pitch.shape
    dev = ref_pitch.device
    best_pitch = ref_pitch[:, C - 2]
    mean_pitch = masked_mean(best_pitch, best_pitch > 0)[:, None, None, None]

    local = 1.0 - ref_merit
    # r1[b, a, c, t] = pitch[c, t], r2[b, a, c, t] = pitch[a, t-1], for t >= 1
    r1 = torch.zeros((B, C, C, T), device=dev, dtype=torch.float32)
    r2 = torch.zeros_like(r1)
    r1[..., 1:] = ref_pitch[:, None, :, 1:]
    r2[..., 1:] = ref_pitch[:, :, None, :-1]
    not0 = torch.arange(T, device=dev) != 0
    i1 = (r1 > 0) & (r2 > 0) & not0
    i2 = (((r1 == 0) & (r2 > 0)) | ((r1 > 0) & (r2 == 0))) & not0
    i3 = (r1 == 0) & (r2 == 0) & not0

    mat1 = torch.abs(r1 - r2) / mean_pitch
    ben2 = F.pad(torch.clamp(torch.abs(energy[:, :-1] - energy[:, 1:]), max=1.0), (1, 0))
    ben2 = ben2[:, None, None, :]

    trans = torch.ones((B, C, C, T), device=dev, dtype=torch.float32)
    trans = torch.where(i1, p["dp_w1"] * mat1, trans)
    trans = torch.where(i2, p["dp_w2"] * (1.0 - ben2), trans)
    trans = torch.where(i3, p["dp_w3"], trans)
    trans = trans / p["dp_w4"]
    # the reference tensor is indexed [prev, next]; viterbi_path wants
    # [next, prev]
    path = viterbi_path_op(local, trans.transpose(1, 2))
    return ref_pitch.gather(1, path[:, None, :])[:, 0]


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------


def _merged_params(opts: Optional[Dict[str, float]]) -> Dict[str, float]:
    return {**DEFAULTS, **(opts or {})}


def frame_geometry(p: Dict[str, float]) -> Tuple[int, int, int, int]:
    """(edge padding, frame size, frame hop, FFT size) in samples."""
    fs = p["sr"]
    to_pad = int(p["frame_length"] / 1000 * int(fs)) // 2
    frame_size = int(math.floor(p["frame_length"] * fs / 1000))
    frame_jump = int(math.floor(p["frame_space"] * fs / 1000))
    return to_pad, frame_size, frame_jump, int(p["fft_length"])


def num_frames(num_samples: int, p: Dict[str, float]) -> int:
    """Frames yaapt_batch returns for ``num_samples`` samples."""
    to_pad, frame_size, frame_jump, _ = frame_geometry(p)
    size = num_samples + 2 * to_pad
    return len(range(frame_size // 2, size - frame_size // 2, frame_jump))


def yaapt_batch(x: torch.Tensor, p: Dict[str, float]) -> torch.Tensor:
    """[B, T] f32 audio -> [B, n_frames] F0 (0 = unvoiced), on x's device.

    The signal and its square are band-passed as one [2B] batch, and both
    NCCF time tracks run as one [2B] pass (the merge only regroups rows).
    Each stage runs in a span ``yaapt.<stage>`` inside ``yaapt.batch``
    (``utils.trace``)."""
    with span("yaapt.batch"):
        B = x.shape[0]
        to_pad, frame_size, frame_jump, nfft = frame_geometry(p)
        x = F.pad(x, (to_pad, to_pad))
        size = x.shape[-1]
        with span("yaapt.bandpass"):
            filt = bandpass(torch.cat([x, x ** 2], dim=0), p["sr"], p["bp_low"], p["bp_high"])
        signal_f, nonlin_f = filt[:B], filt[B:]
        with span("yaapt.nlfer"):
            energy, vuv, n_frames = nlfer(signal_f, frame_size, frame_jump, nfft, p)
        with span("yaapt.spec_track"):
            spec_pitch, pitch_std = spec_track(nonlin_f, energy, vuv, n_frames,
                                               frame_size, frame_jump, nfft, p)
        with span("yaapt.time_track"):
            tp, tm = time_track(filt, torch.cat([spec_pitch, spec_pitch]),
                                torch.cat([pitch_std, pitch_std]), n_frames, frame_jump, size, p)
        with span("yaapt.refine"):
            ref_pitch, ref_merit = refine(tp[:B], tm[:B], tp[B:], tm[B:], spec_pitch, energy,
                                          vuv, p)
        with span("yaapt.dynamic_final"):
            return dynamic_final(ref_pitch, ref_merit, energy, p)


def yaapt(x, opts: Optional[Dict[str, float]] = None, device="cuda") -> torch.Tensor:
    """[B, T] (or [T]) audio -> [B, n_frames] F0 in Hz (0 where unvoiced).

    Runs on ``device`` (CUDA unless the caller asks for the CPU)."""
    p = _merged_params(opts)
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    with torch.no_grad():
        if x.ndim == 1:
            return yaapt_batch(x[None], p)[0]
        return yaapt_batch(x, p)
