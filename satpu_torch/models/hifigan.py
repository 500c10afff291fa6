"""HiFi-GAN generator, discriminators, GAN losses and F0 transforms (port
of ``satpu.models.hifigan``).

Weight norm is an explicit (weight_g, weight_v) pair of plain parameters in
torch layout (conv [out, in, k], conv-transpose [in, out, k], conv2d [out,
in, kh, kw]), so satpu variables load by name. The weight is materialized in
f32 and cast to the compute dtype afterwards. The transposed convs are plain
``F.conv_transpose1d``. Activations are NCW; the discriminators run NCHW
with time on H (``[B, C, T/p, p]``, satpu's NHWC ``[B, T/p, p, C]``).

Spectral norm (the first MSD scale) is satpu's, not
``torch.nn.utils.spectral_norm``: one power iteration from the stored
(u, v) in the discriminator step, with the gradient flowing through it, and
the stored (u, v) as constants otherwise (``SNConv``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh

LRELU_SLOPE = 0.1


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """w = g * v / ||v||, norm over all dims but 0 (torch weight_norm dim=0)."""
    norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
    return g * v / norm


def _widen(x: torch.Tensor) -> torch.Tensor:
    """A bf16 activation back in f32 (f32 and f64 stay as they are)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _init_weight_norm(v: nn.Parameter, g: nn.Parameter,
                      generator: Optional[torch.Generator]) -> None:
    """v ~ N(0, 0.01); g the norm of a second draw, as satpu initializes."""
    v.copy_(torch.randn(v.shape, generator=generator) * 0.01)
    fresh = torch.randn(v.shape, generator=generator) * 0.01
    g.copy_(torch.sqrt((fresh ** 2).sum(dim=tuple(range(1, v.ndim)), keepdim=True)))


class WNConv1d(nn.Module):
    """Weight-normed Conv1d; weight_v [out, in, k], weight_g [out, 1, 1].
    ``dtype`` is the compute dtype (None = the parameters')."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.padding, self.dilation = padding, dilation
        self.dtype = dtype
        self.weight_v = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_weight_norm(self.weight_v, self.weight_g, generator)
        bound = 1.0 / np.sqrt(self.weight_v.shape[1] * self.weight_v.shape[2])
        self.bias.copy_(torch.rand(self.bias.shape, generator=generator) * 2 * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_norm(self.weight_v, self.weight_g)  # in f32, cast after
        dt = self.dtype or w.dtype
        return F.conv1d(x.to(dt), w.to(dt), self.bias.to(dt), padding=self.padding,
                        dilation=self.dilation)


class WNConvTranspose1d(nn.Module):
    """Weight-normed ConvTranspose1d; weight_v [in, out, k], weight_g [in, 1, 1]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dtype = dtype
        self.weight_v = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.weight_g = nn.Parameter(torch.empty(in_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_weight_norm(self.weight_v, self.weight_g, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_norm(self.weight_v, self.weight_g)
        dt = self.dtype or w.dtype
        return F.conv_transpose1d(x.to(dt), w.to(dt), self.bias.to(dt), stride=self.stride,
                                  padding=self.padding)


class ResBlock1(nn.Module):
    """MRF residual block: 3 dilated + 3 plain convs."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d,
                     padding=_get_padding(kernel_size, d), dtype=dtype) for d in dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=1,
                     padding=_get_padding(kernel_size, 1), dtype=dtype) for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d,
                     padding=_get_padding(kernel_size, d), dtype=dtype) for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


@dataclasses.dataclass(frozen=True)
class CoreHifiGanConfig:
    input_dim: int = 256 + 1
    upsample_rates: Tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 8, 8, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    istft_out: bool = False
    istft_n_fft: int = 16
    # "float32" | "bfloat16": conv compute dtype (parameters and the final
    # tanh stay f32)
    compute_dtype: str = "float32"
    # under bfloat16, an upsampling stage narrower than this runs its
    # transposed conv and resblocks in f32 (conv_pre and conv_post follow
    # compute_dtype)
    bf16_min_channels: int = 0


class CoreHifiGan(nn.Module):
    """HiFi-GAN generator core: [B, C_in, T] -> waveform [B, 1, T*prod(rates)]
    (or (spec, phase) [B, n, T_out] each for the iSTFT head)."""

    def __init__(self, cfg: CoreHifiGanConfig):
        super().__init__()
        self.cfg = c = cfg
        dt = torch.bfloat16 if c.compute_dtype == "bfloat16" else None
        self.num_kernels = len(c.resblock_kernel_sizes)
        self.conv_pre = WNConv1d(c.input_dim, c.upsample_initial_channel, 7, padding=3, dtype=dt)
        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch_in = c.upsample_initial_channel // (2 ** i)
            ch = c.upsample_initial_channel // (2 ** (i + 1))
            stage_dt = dt if ch >= c.bf16_min_channels else None
            ups.append(WNConvTranspose1d(ch_in, ch, k, u, padding=(k - u) // 2, dtype=stage_dt))
            resblocks.extend(ResBlock1(ch, rk, tuple(rd), dtype=stage_dt)
                             for rk, rd in zip(c.resblock_kernel_sizes,
                                               c.resblock_dilation_sizes))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        out_ch = (c.istft_n_fft + 2) if c.istft_out else 1
        ch = c.upsample_initial_channel // (2 ** len(c.upsample_rates))
        self.conv_post = WNConv1d(ch, out_ch, 7, padding=3, dtype=dt)

    def forward(self, x: torch.Tensor):
        c = self.cfg
        x = self.conv_pre(x)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            rbs = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            xs = torch.zeros_like(x)
            for rb in rbs:
                xs = xs + rb(x)
            x = xs / self.num_kernels
        x = F.leaky_relu(x)  # default slope 0.01
        x = F.pad(x, (1, 0), mode="reflect")
        x = _widen(self.conv_post(x))
        if c.istft_out:
            n = c.istft_n_fft // 2 + 1
            return torch.exp(x[:, :n]), torch.sin(x[:, n:])
        return torch.tanh(x)


# ---------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride, padding,
            groups: int) -> torch.Tensor:
    """F.conv2d; on the CPU the zero padding is explicit: the CPU (oneDNN)
    conv2d backward with padding corrupts the heap on inputs shorter than
    the kernel (PyTorch 2.13, e.g. a [41, 1] kernel over 13 frames; pinned
    by tests/test_torch_gan_modules.py)."""
    if x.device.type == "cpu":
        x = F.pad(x, (padding[1], padding[1], padding[0], padding[0]))
        padding = (0, 0)
    return F.conv2d(x, w, b, stride=stride, padding=padding, groups=groups)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + 1e-12)


class SNConv(nn.Module):
    """Spectral-normalized Conv2d (1-d convs as [k, 1] kernels), f32.

    ``weight_orig`` [out, in/g, kh, kw] and ``bias`` are parameters; the
    power-iteration vectors ``u`` [out] and ``v`` [in/g * kh * kw] are
    buffers. ``power_iteration()`` runs one torch-style step from the stored
    (u, v) with the gradient flowing through it; ``forward(x, uv)``
    normalizes by sigma = u^T W v of the given (u, v), else of the stored
    ones (constants)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int], padding: Tuple[int, int], groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.register_buffer("u", torch.empty(out_channels))
        self.register_buffer("v", torch.empty(self.weight_orig[0].numel()))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight_orig.copy_(torch.randn(self.weight_orig.shape, generator=generator) * 0.01)
        self.bias.zero_()
        # fixed draws, whatever the seed (satpu: PRNGKey(2) and PRNGKey(3))
        self.u.copy_(torch.randn(self.u.shape, generator=torch.Generator().manual_seed(2)))
        self.v.copy_(torch.randn(self.v.shape, generator=torch.Generator().manual_seed(3)))

    def power_iteration(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """v <- norm(W^T u); u <- norm(W v), differentiable in W."""
        w_mat = self.weight_orig.flatten(1)
        v = _normalize(w_mat.t() @ self.u)
        return _normalize(w_mat @ v), v

    def forward(self, x: torch.Tensor,
                uv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        u, v = uv if uv is not None else (self.u, self.v)
        sigma = u @ (self.weight_orig.flatten(1) @ v)
        return _conv2d(x.to(self.weight_orig.dtype), self.weight_orig / sigma, self.bias,
                       self.stride, self.padding, self.groups)


class WNConv2d(nn.Module):
    """Weight-normed Conv2d; weight_v [out, in/g, kh, kw], weight_g [out, 1,
    1, 1], bias zeros at init. ``dtype`` is the compute dtype (None = the
    parameters')."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int], padding: Tuple[int, int], groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.weight_v = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                                 *kernel_size))
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_weight_norm(self.weight_v, self.weight_g, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_norm(self.weight_v, self.weight_g)
        dt = self.dtype or w.dtype
        return _conv2d(x.to(dt), w.to(dt), self.bias.to(dt), self.stride, self.padding,
                       self.groups)


def _scaled(c: int, channel_scale: float) -> int:
    """A discriminator width under the shrink knob (1.0 = the reference's)."""
    return c if channel_scale == 1.0 else max(4, int(c * channel_scale))


class DiscriminatorP(nn.Module):
    """Period discriminator: [B, 1, T] -> (scores [B, N] f32, 6 feature maps
    f32). T is reflect-padded to a multiple of the period and folded to
    [B, 1, T/p, p]. ``dtype`` is the conv stack's compute dtype;
    ``channel_scale`` shrinks the 32/128/512/1024 ladder."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 dtype: Optional[torch.dtype] = None, channel_scale: float = 1.0):
        super().__init__()
        self.period = period
        c = [_scaled(x, channel_scale) for x in (32, 128, 512, 1024)]
        ins = [1] + c[:-1]
        self.convs = nn.ModuleList(
            [WNConv2d(i, o, (kernel_size, 1), (stride, 1), (_get_padding(5, 1), 0), dtype=dtype)
             for i, o in zip(ins, c)]
            + [WNConv2d(c[-1], c[-1], (kernel_size, 1), (1, 1), (2, 0), dtype=dtype)])
        self.conv_post = WNConv2d(c[-1], 1, (3, 1), (1, 1), (1, 0), dtype=dtype)

    def forward(self, x: torch.Tensor):
        fmap = []
        b, c, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            t += n_pad
        x = x.view(b, c, t // self.period, self.period)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(_widen(x))
        x = _widen(self.conv_post(x))
        fmap.append(x)
        return x.flatten(1), fmap


# (in, out, kernel, stride, padding, groups) of the scale discriminator
_SCALE_CONVS = ((1, 128, 15, 1, 7, 1), (128, 128, 41, 2, 20, 4), (128, 256, 41, 2, 20, 16),
                (256, 512, 41, 4, 20, 16), (512, 1024, 41, 4, 20, 16),
                (1024, 1024, 41, 1, 20, 16), (1024, 1024, 5, 1, 2, 1))


class DiscriminatorS(nn.Module):
    """Scale discriminator: [B, 1, T] -> (scores [B, N] f32, 8 feature maps
    f32), on [B, C, T, 1]. With ``use_spectral_norm`` its convs are SNConv
    (f32 whatever ``dtype``). Under ``channel_scale`` != 1 the groups become
    1 (scaled widths do not keep their divisibility)."""

    def __init__(self, use_spectral_norm: bool = False, dtype: Optional[torch.dtype] = None,
                 channel_scale: float = 1.0):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        convs = []
        for i, (cin, cout, k, s, p, g) in enumerate(_SCALE_CONVS):
            if channel_scale != 1.0:
                cin, cout, g = (_scaled(cin, channel_scale) if i else 1,
                                _scaled(cout, channel_scale), 1)
            convs.append(self._conv(cin, cout, (k, 1), (s, 1), (p, 0), g, dtype))
        self.convs = nn.ModuleList(convs)
        self.conv_post = self._conv(_scaled(1024, channel_scale), 1, (3, 1), (1, 1), (1, 0), 1,
                                    dtype)

    def _conv(self, cin, cout, k, s, p, g, dtype):
        if self.use_spectral_norm:
            return SNConv(cin, cout, k, s, p, groups=g)
        return WNConv2d(cin, cout, k, s, p, groups=g, dtype=dtype)

    def sn_convs(self):
        return list(self.convs) + [self.conv_post]

    def forward(self, x: torch.Tensor, uv: Optional[List] = None):
        """``uv``: one (u, v) per SN conv (``sn_convs`` order), or None for
        the stored ones."""
        fmap = []
        x = x[..., None]
        uv = uv or [None] * len(self.sn_convs())
        for conv, uv_i in zip(self.convs, uv):
            x = conv(x, uv_i) if self.use_spectral_norm else conv(x)
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(_widen(x))
        x = self.conv_post(x, uv[-1]) if self.use_spectral_norm else self.conv_post(x)
        x = _widen(x)
        fmap.append(x)
        return x.flatten(1), fmap


def _avg_pool1d(x: torch.Tensor, kernel: int = 4, stride: int = 2,
                padding: int = 2) -> torch.Tensor:
    """AvgPool1d(4, 2, padding=2), count_include_pad; [B, C, T]."""
    return F.avg_pool1d(x, kernel, stride, padding=padding, count_include_pad=True)


class MultiPeriodDiscriminator(nn.Module):
    """Period discriminators (2, 3, 5, 7, 11 by default). forward(y, y_hat)
    on [B, 1, T] -> (real scores, generated scores, real fmaps, generated
    fmaps), one entry a period."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 periods: Tuple[int, ...] = (2, 3, 5, 7, 11), channel_scale: float = 1.0):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, dtype=dtype, channel_scale=channel_scale) for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            y_d_r, fmap_r = d(y)
            y_d_g, fmap_g = d(y_hat)
            y_d_rs.append(y_d_r)
            fmap_rs.append(fmap_r)
            y_d_gs.append(y_d_g)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiScaleDiscriminator(nn.Module):
    """Scale discriminators over y, avg-pooled by 2 before each scale after
    the first (3 by default); the first is spectral-normed. forward(y,
    y_hat, update_sn): with ``update_sn`` (the discriminator step) scale 0
    runs one power iteration, differentiable, whose (u, v) serve its real
    and generated passes; afterwards the buffers hold detached copies."""

    def __init__(self, dtype: Optional[torch.dtype] = None, num_scales: int = 3,
                 channel_scale: float = 1.0):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0), dtype=dtype, channel_scale=channel_scale)
            for i in range(num_scales))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_sn: bool = False):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            uv = None
            if i != 0:
                y, y_hat = _avg_pool1d(y), _avg_pool1d(y_hat)
            elif update_sn:
                uv = [c.power_iteration() for c in d.sn_convs()]
            y_d_r, fmap_r = d(y, uv) if i == 0 else d(y)
            y_d_g, fmap_g = d(y_hat, uv) if i == 0 else d(y_hat)
            if uv is not None:
                for c, (u, v) in zip(d.sn_convs(), uv):
                    c.u, c.v = u.detach(), v.detach()
            y_d_rs.append(y_d_r)
            fmap_rs.append(fmap_r)
            y_d_gs.append(y_d_g)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# ---------------------------------------------------------------------------
# Losses (LSGAN and feature matching)
# ---------------------------------------------------------------------------


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1.0 - dg) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


# ---------------------------------------------------------------------------
# F0 transformations
# ---------------------------------------------------------------------------


def quantize_f0(x: torch.Tensor, num_bins: int = 16) -> torch.Tensor:
    q = torch.round(x * num_bins) / num_bins
    return torch.where(x == 0, 0.0, q)


def awgn_f0(pitch: torch.Tensor, generator: Optional[torch.Generator] = None,
            target_noise_db: float = 10.0) -> torch.Tensor:
    target_noise_watts = 10.0 ** (target_noise_db / 10.0)
    noise = mesh.global_rows(lambda shape: torch.randn(
        shape, generator=generator, device=pitch.device, dtype=pitch.dtype), pitch.shape)
    noise = noise * np.sqrt(target_noise_watts)
    return torch.where(pitch == 0, 0.0, pitch + noise)


def moving_average_f0(f0: torch.Tensor, n: int = 32) -> torch.Tensor:
    """Zero-padded moving average of width n over the last axis."""
    pad = n // 2
    fp = F.pad(f0, (pad, pad))
    # windowed sums, not a conv: cuDNN would take f32 convs in TF32
    return (fp.unfold(-1, n, 1) * (1.0 / n)).sum(-1)[..., :f0.shape[-1]]


def mean_reverv_f0(f0: torch.Tensor, alpha: float = 0.5, n: int = 32) -> torch.Tensor:
    return (1.0 - alpha) * f0 + alpha * moving_average_f0(f0, n)


def parse_f0_transformation_spec(spec: str):
    """Parse strings like "quant_16_awgn_2" / "mean-reverv_0.5:32" into a list
    of (kind, value) steps."""
    steps = []
    if not spec:
        return steps
    if "quant" in spec:
        num = spec[spec.index("quant"):].split("_")[1]
        steps.append(("quant", int("".join(ch for ch in num if ch.isdigit()))))
    if "awgn" in spec:
        num = spec[spec.index("awgn"):].split("_")[1]
        steps.append(("awgn", int("".join(ch for ch in num if ch.isdigit()))))
    if "mean-reverv" in spec:
        rest = spec[spec.index("mean-reverv"):].split("_")[1]
        alpha = float("".join(ch for ch in rest.split(":")[0] if ch.isdigit() or ch == "."))
        n = int("".join(ch for ch in rest.split(":")[1] if ch.isdigit()))
        steps.append(("mean-reverv", (alpha, n)))
    return steps


def apply_f0_transformation(f0: torch.Tensor, spec: str,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    for kind, value in parse_f0_transformation_spec(spec):
        if kind == "quant":
            f0 = quantize_f0(f0, value)
        elif kind == "awgn":
            f0 = awgn_f0(f0, generator, value)
        elif kind == "mean-reverv":
            alpha, n = value
            f0 = mean_reverv_f0(f0, alpha, n)
    return f0
