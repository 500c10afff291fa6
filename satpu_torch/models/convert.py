"""Weight bridge: satpu flax variables -> satpu_torch ``state_dict``.

``from_satpu_variables`` takes the variable tree of a satpu
``AnonymizationNet``, ``TDNNFNet`` or ``CoreHifiGan`` as nested dicts of
numpy arrays and returns the state_dict of the matching satpu_torch module:

- ``params``: affine weights stay [out, in]; their [1, out] biases become
  [out]. Weight-normed convs are already in torch layout ([out, in, k] /
  [in, out, k]) and keep their (weight_g, weight_v) names.
- ``batch_stats``: BN {mean, var} -> running_mean / running_var.
- ``vq_stats``: the VQ codebook and its EMA accumulators.

Flax scope names become module paths: ``tdnnf{i}`` -> ``tdnnfs.{i-1}``, the
BN layer ``tdnnf_bn`` -> ``tdnnfs.{n}``, ``tdnnf_after{k}`` ->
``tdnnfs_after.{k}``, ``ups_{i}`` / ``resblocks_{i}`` / ``convs1_{j}`` ->
``ups.{i}`` / ``resblocks.{i}`` / ``convs1.{j}``.

``ng_states_from_satpu`` carries a TDNNFNet's ``ng_state`` collection (the
natural-gradient preconditioners, which the port keeps in its trainer, not
in the state_dict) across under the same module paths.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LIST_SCOPE = re.compile(r"^(ups|resblocks|convs1|convs2|convs)_(\d+)$")
_MID_LAYER = re.compile(r"^tdnnf(\d+)$")
_AFTER_LAYER = re.compile(r"^tdnnf_after(\d+)$")
_BN_STAT = {"mean": "running_mean", "var": "running_var"}
_TDNNF_SCOPES = ("tdnn", "prefinal_", "chain_output", "xent_output", "vq_bottleneck")


def _flatten(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def _tdnnf_key(path: Tuple[str, ...], n_mid: int) -> str:
    head, rest = path[0], list(path[1:])
    m, a = _MID_LAYER.match(head), _AFTER_LAYER.match(head)
    if m:
        head = f"tdnnfs.{int(m.group(1)) - 1}"
    elif head == "tdnnf_bn":
        head = f"tdnnfs.{n_mid}"
    elif a:
        head = f"tdnnfs_after.{a.group(1)}"
    elif head == "vq_bottleneck":  # bound at the net's top level in flax
        head = f"tdnnfs.{n_mid}.tdnn.bottleneck_func"
    if rest[-2:-1] == ["bn"] and rest[-1] in _BN_STAT:
        rest[-1] = _BN_STAT[rest[-1]]
    return ".".join([head] + rest)


def _hifigan_key(path: Tuple[str, ...]) -> str:
    return ".".join(_LIST_SCOPE.sub(r"\1.\2", p) for p in path)


def _tensor(path: Tuple[str, ...], arr) -> torch.Tensor:
    a = np.array(arr, dtype=np.float32)  # a writable copy
    if path[-1] == "bias" and a.ndim == 2 and a.shape[0] == 1:
        a = a[0]  # affine bias [1, out] -> [out]
    return torch.from_numpy(np.ascontiguousarray(a))


def _modules(variables: Mapping) -> Iterator[Tuple[str, str, Tuple[str, ...], Any]]:
    """(key prefix, module kind, path inside the module, leaf) for every
    leaf of every collection; the kind is "tdnnf" or "hifigan"."""
    for coll in ("params", "batch_stats", "vq_stats"):
        tree = variables.get(coll) or {}
        if "bn_extractor" in tree or "hifigan" in tree:  # an AnonymizationNet
            parts = [("bn_extractor.", "tdnnf", tree.get("bn_extractor", {})),
                     ("hifigan.", "hifigan", tree.get("hifigan", {}))]
        else:
            tdnnf = any(k.startswith(_TDNNF_SCOPES) for k in tree)
            parts = [("", "tdnnf" if tdnnf else "hifigan", tree)]
        for prefix, kind, sub in parts:
            for path, leaf in _flatten(sub):
                yield prefix, kind, path, leaf


def from_satpu_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """satpu variables {params, batch_stats, vq_stats} -> torch state_dict."""
    entries = list(_modules(variables))
    # the BN layer follows the middle layers tdnnf1..tdnnf{n} in `tdnnfs`
    n_mid = max([int(m.group(1)) for _, kind, path, _ in entries
                 if kind == "tdnnf" and (m := _MID_LAYER.match(path[0]))], default=0)
    return {prefix + (_tdnnf_key(path, n_mid) if kind == "tdnnf" else _hifigan_key(path)):
            _tensor(path, leaf) for prefix, kind, path, leaf in entries}


def ng_states_from_satpu(ng_state: Mapping) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """satpu's per-layer ``ng_state`` tree ({..layer..: {"in"|"out": {W, d,
    rho, t, nrows}}}) -> {module path: {"in"|"out": {W, d, rho, t}}}, the
    layout of ``satpu_torch.chain.trainer.ChainTrainer.ng_states``."""
    entries = list(_flatten(ng_state))
    n_mid = max([int(m.group(1)) for path, _ in entries
                 if (m := _MID_LAYER.match(path[0]))], default=0)
    out: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
    for path, leaf in entries:
        *module, side, key = path
        if key == "nrows":  # a statistics carrier of satpu's custom_vjp
            continue
        name = _tdnnf_key(tuple(module) + ("_",), n_mid)[:-2]
        out.setdefault(name, {}).setdefault(side, {})[key] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
    return out
