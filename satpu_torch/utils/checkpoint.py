"""Self-describing checkpoints: one ``torch.save`` file holding

- ``meta``: ``model_id`` (registry name of the builder), ``build_params``
  (its keyword arguments) and ``speakers`` (the target-speaker table),
  plus any extra JSON-able entries;
- ``state_dict``: the module's tensors, saved from the CPU.

``satpu_torch.infer_helper.load_model`` rebuilds the module from ``meta``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch


def save_checkpoint(path: str, meta: Dict[str, Any], state_dict: Dict[str, torch.Tensor]) -> None:
    """Write {meta, state_dict} to ``path`` (atomic rename)."""
    payload = {"meta": meta,
               "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """-> (meta, state_dict on the CPU)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["meta"], payload["state_dict"]
