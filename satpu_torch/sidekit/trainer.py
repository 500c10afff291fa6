"""ASV training and evaluation (port of ``satpu.sidekit.trainer``;
reference satools/satools/sidekit/{model,objf,monitor}.py).

- ``make_asv_optimizer``: one AdamW (betas 0.9 / 0.999, eps 1e-8) with two
  decay groups, the ArcMargin head (``after_speaker_embedding.*``) at
  ``head_weight_decay`` and every other parameter at ``weight_decay``
  (tuning/ecapa_tdnn.py:55-106); elementwise the update of satpu's optax
  chain;
- ``AsvTrainer``: the train step (satpu's ``init_asv_state`` +
  ``make_asv_train_step``): the learning rate set to ``lr_schedule(step)``
  before the step, the forward in training mode (batch-statistics batch
  norm, SpecAugment masks from the caller's generator, satpu's bf16 policy
  over the frontend and the trunk with ``compute_dtype="bfloat16"``), the
  backward, the AdamW step. Its phases are spans ``asv.<phase>``
  (``PHASES``, ``utils.trace``). Under a process group
  (``parallel.mesh``) each rank takes a contiguous block of the global
  batch: batch norm and the SpecAugment draws are the global batch's, each
  rank's loss is its share of the global mean, and the gradients are
  summed over the ranks (``asv.sync``) before AdamW;
- ``TrainingMonitor``: patience / best-EER tracking (monitor.py:10-252);
- ``extract_xvectors``: per-utterance x-vectors on the model's device, full
  utterances one at a time or fixed windows in batches;
- ``validation_eer``: cosine score matrix with target/non-target masks;
- ``asv_test``: enrollment speaker means, cosine scoring, EER with its
  bootstrap CI, ROCCH-EER, linkability, Cllr / min-Cllr, and AS-norm when a
  cohort is given.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh
from ..utils.trace import span
from . import scoring
from .nn import autocast

PHASES = ("frontend", "forward", "backward", "sync", "optimizer")
HEAD_PREFIX = "after_speaker_embedding."


def make_asv_optimizer(model: torch.nn.Module, lr: float = 1e-3, weight_decay: float = 2e-5,
                       head_weight_decay: float = 2e-4) -> torch.optim.AdamW:
    """AdamW over ``model``'s parameters in two groups: the ArcMargin head
    decays at ``head_weight_decay``, the rest (batch-norm affines and biases
    included) at ``weight_decay``."""
    named = list(model.named_parameters())
    head = [p for n, p in named if n.startswith(HEAD_PREFIX)]
    trunk = [p for n, p in named if not n.startswith(HEAD_PREFIX)]
    return torch.optim.AdamW([{"params": trunk, "weight_decay": weight_decay},
                              {"params": head, "weight_decay": head_weight_decay}],
                             lr=lr, betas=(0.9, 0.999), eps=1e-8)


class AsvTrainer:
    """An x-vector model and its optimizer, on the model's device.

    ``train_step(wav [B, T], target [B], generator)`` runs one step and
    returns {"loss", "accuracy"} as 0-d tensors, without waiting for them.
    ``step`` counts the steps taken; ``lr_schedule(step)`` (the optimizer's
    lr when None) gives each step's learning rate. ``arc_m`` overrides the
    ArcMargin margin (0.4 to fine-tune)."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 arc_m: Optional[float] = None, compute_dtype: str = "float32"):
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.model, self.optimizer = model, optimizer
        self.lr_schedule, self.arc_m = lr_schedule, arc_m
        self.cast = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.step = 0

    def train_step(self, wav: torch.Tensor, target: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if self.lr_schedule is not None:
            lr = self.lr_schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        model = self.model.train()
        # the frontend under the policy too: WavLM's convs and linears are
        # trained (the mel and MFCC frontends hold none)
        with span("asv.frontend"), autocast(self.cast):
            feats = model.features(wav, generator)
        with span("asv.forward"), autocast(self.cast):
            x = model.embed(feats)
            loss, logits = model.after_speaker_embedding(x, target=target, m=self.arc_m)
        accuracy = (logits.argmax(dim=-1) == target).float().mean()
        n = mesh.world()
        if mesh.active():
            # this rank's (equal) block: its share of the global batch's mean
            loss, accuracy = loss / n, accuracy / n
        with span("asv.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        metrics = {"loss": loss.detach(), "accuracy": accuracy}
        if mesh.active():
            with span("asv.sync"):
                mesh.sum_grads_(self.model.parameters())
                metrics = mesh.sum_metrics(metrics)
        with span("asv.optimizer"):
            self.optimizer.step()
        self.step += 1
        return metrics

    def state_dict(self) -> Dict:
        """The optimizer's state and the step: the ``trainer_`` checkpoint."""
        return {"optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


class TrainingMonitor:
    """Patience / early-stop and best-EER tracking (monitor.py:10-252), with
    a plain-dict state for resume."""

    def __init__(self, patience: int = 10):
        self.patience = patience
        self.best_eer = float("inf")
        self.best_epoch = -1
        self.current_patience = patience
        self.history: List[Dict[str, float]] = []

    def update(self, epoch: int, eer: float, **extra) -> bool:
        """Record an epoch; True if it is a new best."""
        self.history.append({"epoch": epoch, "eer": eer, **extra})
        if eer < self.best_eer:
            self.best_eer = eer
            self.best_epoch = epoch
            self.current_patience = self.patience
            return True
        self.current_patience -= 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.current_patience <= 0

    def state_dict(self) -> Dict:
        return dict(patience=self.patience, best_eer=self.best_eer,
                    best_epoch=self.best_epoch, current_patience=self.current_patience,
                    history=self.history)

    def load_state_dict(self, d: Dict) -> None:
        self.__dict__.update(d)


def extract_xvectors(model, wavs: List[np.ndarray], mode: str = "chunked",
                     window: int = 48000, batch_size: int = 64) -> np.ndarray:
    """Per-utterance x-vectors [N, D] on the host (float32 in "full" mode,
    float64 chunk means in "chunked" mode, as satpu's).

    mode="full" is the reference's batch-of-1 full-utterance pass
    (objf.py:228-258). mode="chunked" embeds ``window``-sample chunks
    (short utterances wrap-padded with ``np.resize``; a tail of at least
    half a window kept as the utterance's last ``window`` samples) in
    batches of ``batch_size`` and averages each utterance's chunk
    embeddings. The last batch is not padded: a row of padding never
    reaches a mean."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        if mode == "full":
            out = [model(torch.from_numpy(np.asarray(w, np.float32).reshape(1, -1))
                         .to(device))[1] for w in wavs]
            return torch.cat(out).cpu().numpy()
        if mode != "chunked":
            raise ValueError(f"unknown x-vector mode {mode!r}")
        chunks, owners = [], []
        for i, w in enumerate(wavs):
            x = np.asarray(w, np.float32).reshape(-1)
            if len(x) <= window:
                chunks.append(np.resize(x, window))  # wrap-pad short utterances
                owners.append(i)
            else:
                for s in range(0, len(x) - window + 1, window):
                    chunks.append(x[s:s + window])
                    owners.append(i)
                if len(x) % window >= window // 2:  # keep a meaningful tail
                    chunks.append(x[-window:])
                    owners.append(i)
        embs = [model(torch.from_numpy(np.stack(chunks[s:s + batch_size])).to(device))[1]
                for s in range(0, len(chunks), batch_size)]
        embs = torch.cat(embs).cpu().numpy()
    owners = np.asarray(owners)
    out = np.zeros((len(wavs), embs.shape[1]), np.float32)
    counts = np.zeros(len(wavs))
    np.add.at(out, owners, embs)
    np.add.at(counts, owners, 1.0)
    return out / np.maximum(counts[:, None], 1.0)


def validation_eer(embeddings: np.ndarray, labels: np.ndarray) -> float:
    """Cosine score matrix + target/non-target masks (objf.py:132-186)."""
    e = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
    scores = e @ e.T
    labels = np.asarray(labels)
    same = labels[:, None] == labels[None, :]
    iu = np.triu_indices(len(labels), k=1)
    tar = scores[iu][same[iu]]
    non = scores[iu][~same[iu]]
    return scoring.eer_point(tar, non)


def asv_test(model, enroll: Dict[str, List[np.ndarray]],
             trials: List[Tuple[str, str, bool]],
             trial_wavs: Dict[str, np.ndarray],
             cohort_xv: Optional[np.ndarray] = None,
             metric_path: Optional[str] = None,
             xvector_mode: str = "chunked",
             ece_plot_path: Optional[str] = None) -> Dict[str, float]:
    """Full trial evaluation: enroll spk-means, cosine scoring, EER/CI,
    linkability, min-Cllr (+ AS-norm variants when a cohort is given).

    enroll: {spk: [wav, ...]}; trials: [(spk, utt, is_target)];
    trial_wavs: {utt: wav}.
    """
    spk_xv = {}
    for spk, wavs in enroll.items():
        xv = extract_xvectors(model, wavs, mode=xvector_mode)
        mean = xv.mean(axis=0)
        spk_xv[spk] = mean / np.maximum(np.linalg.norm(mean), 1e-12)
    utts = list(trial_wavs.keys())
    utt_xv_arr = extract_xvectors(model, [trial_wavs[u] for u in utts], mode=xvector_mode)
    utt_xv = {u: v for u, v in zip(utts, utt_xv_arr)}

    e1 = np.stack([spk_xv[s] for s, _, _ in trials])
    e2 = np.stack([utt_xv[u] for _, u, _ in trials])
    is_tar = np.asarray([t for _, _, t in trials], bool)
    scores_all = scoring.cosine_scoring(e1, e2)
    tar, non = scores_all[is_tar], scores_all[~is_tar]

    eer, lo, hi = scoring.eer_ci_bootstrap(tar, non)
    dsys = scoring.linkability(tar, non)[0]
    cllr_min, rocch_eer = scoring.min_cllr(tar, non, compute_eer=True)
    cllr_act = scoring.cllr(tar, non)
    metrics = {
        "eer": eer * 100, "eer_ci_lower": lo * 100, "eer_ci_upper": hi * 100,
        "rocch_eer": rocch_eer * 100, "linkability": float(dsys),
        "cllr": float(cllr_act), "min_cllr": float(cllr_min),
    }
    if cohort_xv is not None:
        sn = scoring.asnorm(scores_all, e1, e2, cohort_xv)
        tar_n, non_n = sn[is_tar], sn[~is_tar]
        metrics["asnorm_eer"] = scoring.eer_point(tar_n, non_n) * 100
        metrics["asnorm_linkability"] = float(scoring.linkability(tar_n, non_n)[0])
        metrics["asnorm_min_cllr"] = float(scoring.min_cllr(tar_n, non_n))
    if ece_plot_path:
        # the reference plots the PAV-calibrated LLRs (metric.py:815-847)
        tar_opt, non_opt = scoring.optimal_llr(tar, non)
        metrics["dece"] = float(scoring.dece(tar_opt, non_opt))
        metrics["ece_plot"] = scoring.ece_plot(tar_opt, non_opt, ece_plot_path)
    if metric_path:
        with open(metric_path, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics
