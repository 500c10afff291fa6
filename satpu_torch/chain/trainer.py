"""LF-MMI training step of the TDNN-F extractor (port of ``satpu.chain.trainer``).

One step: the network's training forward (dropout, batch statistics, the
VQ EMA update), the chain objective plus the VQ commitment loss, the
backward (its den part is kernel K2b on the card), natural-gradient
preconditioning of every affine's gradient, then clip-by-value 5 and AdamW
(Adam with decoupled weight decay 0.001, eps 1e-8; optax's ``adamw``). With
``grad_acc_steps`` k the optimizer steps on the mean gradient of every k
minibatches (optax's ``MultiSteps``). The learning rate is set each step
from ``lr_schedule(step)`` at the step count before the increment, and
every ``orthonormal_interval``-th step re-orthonormalizes the ``inner_nat``
weights.

The natural-gradient states live here, keyed by module name
(``ng_states``), not in the model's state_dict: a trained checkpoint has
exactly the serving extractor's keys.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..models.tdnnf import NaturalAffineTransform, constrain_orthonormal, orthonormal_weights
from . import ngsgd
from .objf import DenominatorGraph, chain_objf_and_grad

# the profiler ranges of a step, ``chain.<phase>``, in order
PHASES = ("net_forward", "objective_forward", "objective_backward", "net_backward", "ng",
          "optimizer")


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


def init_ng_states(model: nn.Module, seed: int = 0) -> Dict[str, Dict[str, ngsgd.State]]:
    """Fresh preconditioner states for every NG layer of ``model`` (random
    bases from ``seed``), on the model's device."""
    g = torch.Generator().manual_seed(seed)
    dev = next(model.parameters()).device
    return {name: {side: {k: v.to(dev) for k, v in ngsgd.ng_init(dim, generator=g).items()}
                   for side, dim in (("in", m.in_dim + 1), ("out", m.out_dim))}
            for name, m in ng_layers(model)}


class ChainTrainer:
    """Owns the optimizer, the NG states and the dropout generator of one
    chain training run of ``model`` (a ``models.asrbn.TDNNFNet``)."""

    def __init__(self, model: nn.Module, den: DenominatorGraph,
                 opts: ChainTrainOpts = ChainTrainOpts(), grad_acc_steps: int = 1,
                 lr_schedule: Optional[Callable[[int], float]] = None, seed: int = 0,
                 ng_states: Optional[Dict[str, Dict[str, ngsgd.State]]] = None):
        self.model, self.den, self.opts = model, den, opts
        self.grad_acc_steps = grad_acc_steps
        self.lr_schedule = lr_schedule
        self.device = next(model.parameters()).device
        self.params = [p for p in model.parameters()]
        self.optimizer = torch.optim.AdamW(self.params, lr=opts.lr, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=opts.weight_decay)
        self.step_count = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._acc: Optional[List[torch.Tensor]] = None
        self._acc_n = 0
        self.ng_slots: Dict[str, ngsgd.NGSlot] = {}
        if model.cfg.natural_gradient:
            states = ng_states if ng_states is not None else init_ng_states(model, seed)
            for name, m in ng_layers(model):
                st = {side: {k: v.to(self.device, m.weight.dtype).clone()
                             for k, v in states[name][side].items()} for side in ("in", "out")}
                m.ng_slot = self.ng_slots[name] = ngsgd.NGSlot(st["in"], st["out"])

    @property
    def ng_states(self) -> Dict[str, Dict[str, ngsgd.State]]:
        return {name: slot.state for name, slot in self.ng_slots.items()}

    def lr_now(self) -> float:
        return (float(self.lr_schedule(self.step_count)) if self.lr_schedule is not None
                else self.opts.lr)

    def compute_grads(self, wav: torch.Tensor, num_graphs: Dict[str, torch.Tensor],
                      num_frames: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training forward + backward on one minibatch; leaves the
        (preconditioned, with NG) gradients in ``p.grad``. Returns (loss,
        metrics), detached.

        The objective runs in f32 whatever the network's dtype, as in satpu.
        The backward runs in two stages, the objective's (numerator and den
        backward, into the detached network outputs) and then the network's:
        the chain rule split at the outputs, so the gradients are those of
        one ``loss.backward()``. Each phase runs in a profiler range
        ``chain.<phase>`` (``PHASES``)."""
        o = self.opts
        self.model.train()
        for p in self.params:
            p.grad = None
        with record_function("chain.net_forward"):
            chain_out, xent_out, aux = self.model(wav.to(self.params[0].dtype),
                                                  generator=self.generator)
        with record_function("chain.objective_forward"):
            co = chain_out.detach().float().requires_grad_(True)
            xo = xent_out.detach().float().requires_grad_(True)
            loss, metrics = chain_objf_and_grad(
                co, xo, num_graphs, self.den, num_frames=num_frames,
                leaky_hmm_coefficient=o.leaky_hmm_coefficient,
                l2_regularize=o.l2_regularize, xent_regularize=o.xent_regularize)
        with record_function("chain.objective_backward"):
            loss.backward()
        with record_function("chain.net_backward"):
            outputs = [chain_out, xent_out]
            grads = [co.grad.to(chain_out.dtype), xo.grad.to(xent_out.dtype)]
            if "vq_loss" in aux:
                loss = loss + aux["vq_loss"].detach()
                metrics["vq_loss"] = aux["vq_loss"].detach()
                metrics["vq_perplexity"] = aux["vq_perplexity"]
                outputs.append(aux["vq_loss"])
                grads.append(torch.ones_like(aux["vq_loss"]))
            torch.autograd.backward(outputs, grads)
        if self.ng_slots:
            with record_function("chain.ng"):
                mods = dict(ng_layers(self.model))
                pre = ngsgd.precondition_gradients(
                    self.ng_slots, {n: mods[n].weight.grad for n in self.ng_slots},
                    {n: mods[n].bias.grad for n in self.ng_slots})
                for n, (gw, gb) in pre.items():
                    mods[n].weight.grad, mods[n].bias.grad = gw.contiguous(), gb.contiguous()
        return loss.detach(), metrics

    @torch.no_grad()
    def apply_grads(self, lr: float) -> None:
        """Accumulate this step's gradients; every ``grad_acc_steps``-th step,
        clip their mean by value and take the AdamW step at ``lr``."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.grad_acc_steps > 1:
            n = self._acc_n
            self._acc = (grads if self._acc is None else
                         [(g + n * a) / (n + 1) for g, a in zip(grads, self._acc)])
            self._acc_n += 1
            if self._acc_n < self.grad_acc_steps:
                return
            grads, self._acc, self._acc_n = self._acc, None, 0
        for p, g in zip(self.params, grads):
            p.grad = g.clamp(-self.opts.grad_clip_value, self.opts.grad_clip_value)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    @torch.no_grad()
    def apply_orthonormal_constraint(self) -> None:
        for _, w in orthonormal_weights(self.model):
            w.copy_(constrain_orthonormal(w, -1.0))

    def step(self, wav: torch.Tensor, num_graphs: Dict[str, torch.Tensor],
             num_frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training step; returns its metrics (device tensors) with
        ``loss`` and ``lr``. The update and the orthonormal constraint run
        in the profiler range ``chain.optimizer``."""
        lr = self.lr_now()
        loss, metrics = self.compute_grads(wav, num_graphs, num_frames)
        with record_function("chain.optimizer"):
            self.apply_grads(lr)
            self.step_count += 1
            if self.step_count % self.opts.orthonormal_interval == 0:
                self.apply_orthonormal_constraint()
        metrics["loss"] = loss
        metrics["lr"] = torch.tensor(lr)
        return metrics

    def state_dict(self) -> Dict:
        """Optimizer, NG states, accumulation, step count and dropout RNG."""
        return {"step": self.step_count, "optimizer": self.optimizer.state_dict(),
                "ng_states": {n: {s: {k: v.cpu() for k, v in st.items()}
                                  for s, st in sides.items()}
                              for n, sides in self.ng_states.items()},
                "acc": [a.cpu() for a in self._acc] if self._acc is not None else [],
                "acc_n": self._acc_n, "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict) -> None:
        self.step_count = int(state["step"])
        self.optimizer.load_state_dict(state["optimizer"])
        for n, sides in state["ng_states"].items():
            for s, st in sides.items():
                self.ng_slots[n].state[s].update(
                    {k: v.to(self.device) for k, v in st.items()})
        self._acc = [a.to(self.device) for a in state["acc"]] or None
        self._acc_n = int(state["acc_n"])
        self.generator.set_state(state["generator"])


@torch.no_grad()
def chain_valid_metrics(model: nn.Module, den: DenominatorGraph, wav: torch.Tensor,
                        num_graphs: Dict[str, torch.Tensor], num_frames: torch.Tensor,
                        opts: ChainTrainOpts = ChainTrainOpts()) -> Dict[str, torch.Tensor]:
    """The chain objective on held-out egs with the network in eval mode."""
    model.eval()
    chain_out, xent_out = model(wav)
    loss, metrics = chain_objf_and_grad(
        chain_out, xent_out, num_graphs, den, num_frames=num_frames,
        leaky_hmm_coefficient=opts.leaky_hmm_coefficient,
        l2_regularize=opts.l2_regularize, xent_regularize=opts.xent_regularize)
    metrics["loss"] = loss
    return metrics


def merge_models(state_dicts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Parameter averaging of several models' state_dicts."""
    n = len(state_dicts)
    return {k: sum(sd[k] for sd in state_dicts) / n for k in state_dicts[0]}
