"""Self-describing checkpoints: one ``torch.save`` file holding

- ``meta``: ``model_id`` (registry name of the builder), ``build_params``
  (its keyword arguments) and ``speakers`` (the target-speaker table),
  plus any extra JSON-able entries;
- ``state_dict``: the module's tensors, saved from the CPU.

``satpu_torch.infer_helper.load_model`` rebuilds the module from ``meta``.
Trainer checkpoints (optimizer and natural-gradient states) are plain
``torch.save`` files beside them; ``latest_checkpoint`` / ``checkpoint_gc``
find and prune both by their integer tags.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def _save_atomic(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, meta: Dict[str, Any], state_dict: Dict[str, torch.Tensor]) -> None:
    """Write {meta, state_dict} to ``path`` (atomic rename)."""
    _save_atomic(path, {"meta": meta,
                        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}})


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """-> (meta, state_dict on the CPU)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["meta"], payload["state_dict"]


def match_params(template: Dict[str, torch.Tensor], loaded: Dict[str, torch.Tensor]):
    """Shape-aware partial init (``init_weight_model`` warm starts): every
    entry of ``loaded`` whose key exists in ``template`` with the same shape
    replaces it. Returns (merged state_dict, matched keys, the loaded keys
    that found no home, sorted)."""
    merged, matched = dict(template), []
    for k, v in loaded.items():
        if k in template and tuple(v.shape) == tuple(template[k].shape):
            merged[k] = v.to(template[k].dtype)
            matched.append(k)
    return merged, matched, sorted(set(loaded) - set(matched))


def tagged_checkpoints(exp_dir: str, prefix: str, suffix: str):
    """[(integer tag, file name)] of the ``<prefix><tag><suffix>`` files in
    ``exp_dir``, by tag."""
    if not os.path.isdir(exp_dir):
        return []
    out = []
    for name in os.listdir(exp_dir):
        if name.startswith(prefix) and name.endswith(suffix):
            tag = name[len(prefix): len(name) - len(suffix)].strip("_.")
            if tag.isdigit():
                out.append((int(tag), name))
    return sorted(out)


def latest_checkpoint(exp_dir: str, prefix: str = "", suffix: str = ".ckpt") -> Optional[str]:
    """The checkpoint with the highest integer tag, e.g. ``trainer_100.ckpt``."""
    entries = tagged_checkpoints(exp_dir, prefix, suffix)
    return os.path.join(exp_dir, entries[-1][1]) if entries else None


def checkpoint_gc(exp_dir: str, prefix: str, suffix: str = ".ckpt", keep_last: int = 10,
                  keep_every: int = 0, protected=()) -> None:
    """Delete all but the ``keep_last`` newest tagged checkpoints (all of
    them when ``keep_last`` is 0), sparing every tag that is a multiple of
    ``keep_every`` and the targets of the ``protected`` paths (symlinks such
    as ``g_best.ckpt`` are followed)."""
    entries = tagged_checkpoints(exp_dir, prefix, suffix)
    protected = {os.path.basename(os.path.realpath(p)) for p in protected if p}
    for tag, name in entries[:-keep_last] if keep_last else entries:
        if (keep_every and tag % keep_every == 0) or name in protected:
            continue
        os.remove(os.path.join(exp_dir, name))


def save_trainer_checkpoint(path: str, meta: Dict[str, Any], state: Dict[str, Any]) -> None:
    """Write a trainer's state ({optimizer, NG states, ...} of tensors and
    plain values, on the CPU) with its ``meta`` (atomic rename)."""
    _save_atomic(path, {"meta": meta, "trainer": state})


def load_trainer_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (meta, trainer state on the CPU)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["meta"], payload["trainer"]
