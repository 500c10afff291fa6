"""Frozen copy of ``satpu_torch/chain/trainer.py`` for the benchmark's plain reference.

Cut to what the chain cells run: one process, float32, one optimizer
group, every minibatch a step. The port's data-parallel sync, gradient
accumulation, bf16 training policy, parameter groups (preprocessor
schedule, frozen parameters), checkpoint state, held-out metrics and
model merging are left out, and so are its profiler ranges.

LF-MMI training step of the ASR-BN extractors (port of ``satpu.chain.trainer``).

One step: the network's training forward (dropout, batch statistics, the
VQ EMA update), the chain objective plus the network's auxiliary losses
(its aux outputs whose names end in ``_loss``: the VQ commitment; the rest
are metrics), the backward, natural-gradient preconditioning of every
affine's gradient, then clip-by-value 5 and AdamW (Adam with decoupled
weight decay 0.001, eps 1e-8; optax's ``adamw``). The learning rate is set
each step from ``lr_schedule(step)`` at the step count before the
increment, and every ``orthonormal_interval``-th step re-orthonormalizes
the ``inner_nat`` weights.

The natural-gradient states live here, keyed by module name
(``ng_states``), not in the model's state_dict.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn

from .tdnnf import NaturalAffineTransform, constrain_orthonormal, orthonormal_weights
from . import ngsgd
from .objf import DenominatorGraph, chain_objf_and_grad


@dataclasses.dataclass(frozen=True)
class ChainTrainOpts:
    lr: float = 0.01
    weight_decay: float = 0.001
    grad_clip_value: float = 5.0
    l2_regularize: float = 1e-4
    leaky_hmm_coefficient: float = 1e-5
    xent_regularize: float = 0.025
    orthonormal_interval: int = 4


def ng_layers(model: nn.Module) -> List[Tuple[str, NaturalAffineTransform]]:
    """Every affine with a bias: the layers natural gradient preconditions."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, NaturalAffineTransform) and m.bias is not None]


class ChainTrainer:
    """Owns the optimizer, the NG states and the dropout generator of one
    chain training run of ``model`` (a ``asrbn.TDNNFNet`` with natural
    gradient on)."""

    def __init__(self, model: nn.Module, den: DenominatorGraph,
                 opts: ChainTrainOpts, lr_schedule: Callable[[int], float], seed: int,
                 ng_states: Dict[str, Dict[str, ngsgd.State]]):
        self.model, self.den, self.opts = model, den, opts
        self.lr_schedule = lr_schedule
        self.device = next(model.parameters()).device
        self.params = [p for _, p in model.named_parameters()]
        self.optimizer = torch.optim.AdamW(
            [{"params": self.params}], lr=opts.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=opts.weight_decay)
        self.step_count = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.ng_slots: Dict[str, ngsgd.NGSlot] = {}
        for name, m in (ng_layers(model) if model.cfg.natural_gradient else ()):
            st = {side: {k: v.to(self.device, m.weight.dtype).clone()
                         for k, v in ng_states[name][side].items()} for side in ("in", "out")}
            m.ng_slot = self.ng_slots[name] = ngsgd.NGSlot(st["in"], st["out"])

    def compute_grads(self, wav: torch.Tensor, num_graphs: Dict[str, torch.Tensor],
                      num_frames: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training forward + backward on one minibatch; leaves the
        preconditioned gradients in ``p.grad``. Returns (loss, metrics),
        detached. The objective runs in f32. The backward runs in two
        stages, the objective's (numerator and den backward, into the
        detached network outputs) and then the network's: the chain rule
        split at the outputs, so the gradients are those of one
        ``loss.backward()``."""
        o = self.opts
        self.model.train()
        for p in self.params:
            p.grad = None
        for slot in self.ng_slots.values():
            slot.stats = None
        chain_out, xent_out, aux = self.model(wav.to(self.params[0].dtype),
                                              generator=self.generator)
        co = chain_out.detach().float().requires_grad_(True)
        xo = xent_out.detach().float().requires_grad_(True)
        loss, metrics = chain_objf_and_grad(
            co, xo, num_graphs, self.den, num_frames=num_frames,
            leaky_hmm_coefficient=o.leaky_hmm_coefficient,
            l2_regularize=o.l2_regularize, xent_regularize=o.xent_regularize)
        loss.backward()
        outputs = [chain_out, xent_out]
        grads = [co.grad.to(chain_out.dtype), xo.grad.to(xent_out.dtype)]
        for name, value in aux.items():
            if name.endswith("_loss"):
                loss = loss + value.detach().float()
                outputs.append(value)
                grads.append(torch.ones_like(value))
            metrics[name] = value.detach().float()
        torch.autograd.backward(outputs, grads)
        mods = dict(ng_layers(self.model))
        pre = ngsgd.precondition_gradients(
            self.ng_slots, {n: mods[n].weight.grad for n in self.ng_slots},
            {n: mods[n].bias.grad for n in self.ng_slots})
        for n, (gw, gb) in pre.items():
            mods[n].weight.grad, mods[n].bias.grad = gw.contiguous(), gb.contiguous()
        return loss.detach(), metrics

    @torch.no_grad()
    def apply_grads(self, lr: float) -> None:
        """Clip the gradients by value and take the AdamW step at ``lr``."""
        for p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = g.clamp(-self.opts.grad_clip_value, self.opts.grad_clip_value)
        self.optimizer.param_groups[0]["lr"] = lr
        self.optimizer.step()

    @torch.no_grad()
    def apply_orthonormal_constraint(self) -> None:
        for _, w in orthonormal_weights(self.model):
            w.copy_(constrain_orthonormal(w, -1.0))

    def step(self, wav: torch.Tensor, num_graphs: Dict[str, torch.Tensor],
             num_frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training step; returns its metrics (device tensors) with
        ``loss`` and ``lr``."""
        lr = float(self.lr_schedule(self.step_count))
        loss, metrics = self.compute_grads(wav, num_graphs, num_frames)
        self.apply_grads(lr)
        self.step_count += 1
        if self.step_count % self.opts.orthonormal_interval == 0:
            self.apply_orthonormal_constraint()
        metrics["loss"] = loss
        metrics["lr"] = torch.tensor(lr)
        return metrics
