"""HiFi-GAN adversarial training of the anonymization generator (port of
``satpu.hifigan.trainer``).

Two AdamW optimizers (lr 2e-4, betas (0.8, 0.99), weight decay 0.01, eps
1e-8; elementwise the update of ``optax.adamw``) with the lr set to
``lr * lr_decay ** epoch`` before each step. A step is a discriminator step
(MPD + MSD LSGAN, one spectral-norm power iteration) followed by a
generator step against the updated discriminators (mel L1 x45 + feature
matching + LSGAN). The generator is the ``hifigan.*`` part of an
``AnonymizationNet``: it consumes cached (bn, f0, spk) features and is
trained against the aligned audio segments of ``hifigan.dataset``; the rest
of the anonymizer (the bottleneck extractor) stays frozen.

The generator runs once a step: the discriminator step reads its output
detached, the generator step backs up through the same graph (satpu runs it
twice with the same parameters; the value is the same).

Each phase of a step is a span (``utils.trace``) named ``gan.<phase>``
(``PHASES``).

Under a process group (``parallel.mesh``) each rank trains on its block of
the global batch: its losses are its shares of the global batch's means,
the D gradients are summed over the ranks after the D backward and the G
gradients after the G backward (whose backward reaches no D parameter), so
both optimizers step alike on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.anonymizer import AnonymizationNet
from ..parallel import mesh
from ..models.hifigan import (MultiPeriodDiscriminator, MultiScaleDiscriminator,
                              discriminator_loss, feature_loss, generator_loss)
from ..ops.mel import mel_spectrogram
from ..utils.trace import span

PHASES = ("generator", "d_forward", "d_backward", "d_sync", "d_optimizer", "g_forward",
          "g_backward", "g_sync", "g_optimizer")
GENERATOR_PREFIX = "hifigan."


@dataclasses.dataclass(frozen=True)
class GanHparams:
    lr: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999  # per epoch
    weight_decay: float = 0.01
    segment_size: int = 16640
    n_fft: int = 1024
    num_mels: int = 80
    sampling_rate: int = 16000
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0
    mel_weight: float = 45.0
    # "float32" | "bfloat16": compute dtype of the weight-normed
    # discriminators (the generator's is the anonymizer config's). Params,
    # losses, the mel comparison and the spectral-normed scale stay f32.
    compute_dtype: str = "float32"
    # shrink knobs of the discriminator stacks; the defaults are the
    # reference's widths
    mpd_periods: tuple = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    disc_channel_scale: float = 1.0

    def mel_kwargs(self) -> Dict:
        return dict(n_fft=self.n_fft, num_mels=self.num_mels, sampling_rate=self.sampling_rate,
                    hop_size=self.hop_size, win_size=self.win_size, fmin=self.fmin,
                    fmax=self.fmax)


def split_generator_params(state_dict: Dict[str, torch.Tensor]
                           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """An anonymizer's state_dict -> (trainable ``hifigan.*`` entries, the
    frozen rest)."""
    train = {k: v for k, v in state_dict.items() if k.startswith(GENERATOR_PREFIX)}
    return train, {k: v for k, v in state_dict.items() if k not in train}


def merge_generator_params(train: Dict[str, torch.Tensor],
                           frozen: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {**frozen, **train}


def batch_to(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A dataset batch (numpy) on ``device``; through pinned memory to a card."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                  else t.to(device))
    return out


class GanTrainer:
    """The generator (``model.hifigan``), the MPD and the MSD with their
    optimizers, on the model's device. ``epoch`` sets the lr decay."""

    def __init__(self, model: AnonymizationNet, h: GanHparams = GanHparams(), seed: int = 0):
        from ..infer_helper import init_weights

        self.model, self.h = model, h
        self.device = next(model.parameters()).device
        dt = torch.bfloat16 if h.compute_dtype == "bfloat16" else None
        self.mpd = init_weights(MultiPeriodDiscriminator(
            dtype=dt, periods=h.mpd_periods, channel_scale=h.disc_channel_scale), seed)
        self.msd = init_weights(MultiScaleDiscriminator(
            dtype=dt, num_scales=h.msd_scales, channel_scale=h.disc_channel_scale), seed + 1)
        self.mpd.to(self.device), self.msd.to(self.device)
        self.g_params = []
        for name, p in model.named_parameters():
            p.requires_grad_(name.startswith(GENERATOR_PREFIX))
            if p.requires_grad:
                self.g_params.append(p)
        self.d_params = list(self.mpd.parameters()) + list(self.msd.parameters())
        kw = dict(lr=h.lr, betas=(h.adam_b1, h.adam_b2), eps=1e-8, weight_decay=h.weight_decay)
        self.opt_g = torch.optim.AdamW(self.g_params, **kw)
        self.opt_d = torch.optim.AdamW(self.d_params, **kw)
        self.step, self.epoch = 0, 0
        # drives the random F0 transformations (awgn) of the generator input
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def lr_now(self) -> float:
        return self.h.lr * self.h.lr_decay ** self.epoch

    def _generate(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(audio, generated audio), both cut to the shorter length."""
        y_gen = self.model.forward_decoder(batch["f0"], batch["bn"], batch["spk"],
                                           generator=self.generator)
        t = min(batch["audio"].shape[-1], y_gen.shape[-1])
        return batch["audio"][:, :t], y_gen[:, :t]

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One D step then one G step on a batch {"bn" [B, C, T_bn], "f0"
        [B, T_f0], "spk" [B, S], "audio" [B, T]} on the device. Returns the
        metrics as 0-d tensors (``lr`` a float) without waiting for them."""
        h = self.h
        lr = self.lr_now()
        for opt in (self.opt_g, self.opt_d):
            for group in opt.param_groups:
                group["lr"] = lr
        with span("gan.generator"):
            y, y_gen = self._generate(batch)
            y3 = y[:, None]

        with span("gan.d_forward"):
            yg3 = y_gen.detach()[:, None]
            df_r, df_g, _, _ = self.mpd(y3, yg3)
            ds_r, ds_g, _, _ = self.msd(y3, yg3, update_sn=True)
            loss_d = discriminator_loss(df_r, df_g)[0] + discriminator_loss(ds_r, ds_g)[0]
        n = mesh.world()
        if mesh.active():
            loss_d = loss_d / n  # this rank's share of the global batch's mean
        with span("gan.d_backward"):
            self.opt_d.zero_grad(set_to_none=True)
            loss_d.backward()
        if mesh.active():
            with span("gan.d_sync"):
                mesh.sum_grads_(self.d_params)
        with span("gan.d_optimizer"):
            self.opt_d.step()

        with span("gan.g_forward"):
            mel_real = mel_spectrogram(y, **h.mel_kwargs())
            mel_gen = mel_spectrogram(y_gen, **h.mel_kwargs())
            loss_mel = torch.mean(torch.abs(mel_real - mel_gen)) * h.mel_weight
            yg3 = y_gen[:, None]
            _, df_g, fmap_f_r, fmap_f_g = self.mpd(y3, yg3)
            _, ds_g, fmap_s_r, fmap_s_g = self.msd(y3, yg3)
            loss_g = (generator_loss(ds_g)[0] + generator_loss(df_g)[0]
                      + feature_loss(fmap_s_r, fmap_s_g) + feature_loss(fmap_f_r, fmap_f_g)
                      + loss_mel)
            if mesh.active():
                loss_g, loss_mel = loss_g / n, loss_mel / n
        with span("gan.g_backward"):
            self.opt_g.zero_grad(set_to_none=True)
            # the discriminators take no gradient from the G step
            loss_g.backward(inputs=self.g_params)
        metrics = {"loss_gen_all": loss_g.detach(), "loss_disc_all": loss_d.detach(),
                   "mel_spec_error": loss_mel.detach() / h.mel_weight}
        if mesh.active():
            with span("gan.g_sync"):
                mesh.sum_grads_(self.g_params)
                metrics = mesh.sum_metrics(metrics)
        with span("gan.g_optimizer"):
            self.opt_g.step()
        self.step += 1
        return {**metrics, "lr": lr}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The validation error: the unweighted mel L1."""
        y, y_gen = self._generate(batch)
        kw = self.h.mel_kwargs()
        return torch.mean(torch.abs(mel_spectrogram(y, **kw) - mel_spectrogram(y_gen, **kw)))

    @torch.no_grad()
    def sample_step(self, batch: Dict[str, torch.Tensor]):
        """(generated audio, its log-mel, the real log-mel)."""
        y, y_gen = self._generate(batch)
        kw = self.h.mel_kwargs()
        return y_gen, mel_spectrogram(y_gen, **kw), mel_spectrogram(y, **kw)

    def discriminator_state_dict(self) -> Dict[str, torch.Tensor]:
        """The MPD's and MSD's tensors (the MSD's with its spectral (u, v)),
        under ``mpd.`` / ``msd.``: the ``d_`` checkpoint."""
        return {**{f"mpd.{k}": v for k, v in self.mpd.state_dict().items()},
                **{f"msd.{k}": v for k, v in self.msd.state_dict().items()}}

    def load_discriminator_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for name, module in (("mpd", self.mpd), ("msd", self.msd)):
            module.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                                    if k.startswith(name + ".")})

    def state_dict(self) -> Dict:
        """The optimizers' states and the counters: the ``trainer_`` checkpoint."""
        return {"opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict(),
                "step": self.step, "epoch": self.epoch}

    def load_state_dict(self, state: Dict) -> None:
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])
