"""Model registry + self-describing checkpoint loading (port of
``satpu.infer_helper``).

Checkpoints carry a ``model_id`` resolved through a registry of builders
(``asrbn_tdnnf``, ``asrbn_tdnnf_spkadv`` with ``num_speakers`` /
``adversarial``, ``asrbn_tdnnf_wav2vec2`` with its ``wav2vec2`` config dict,
``anonymizer_tdnnf_hifigan``, ``asv_xvector``) plus the JSON build params; ``load_model`` rebuilds the module on the
requested device (CUDA by default) and loads its weights.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from . import resolve_device
from .utils.checkpoint import load_checkpoint, save_checkpoint

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}


def register_model(model_id: str):
    def deco(builder):
        MODEL_REGISTRY[model_id] = builder
        return builder

    return deco


def _tuplify(kwargs):
    """JSON round-trips tuples as lists; dataclass configs want tuples back."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}


def _register_builtins():
    from .models.anonymizer import AnonymizationNet, AnonymizerConfig
    from .models.asrbn import TDNNFNet, TDNNFNetConfig

    if "asrbn_tdnnf" in MODEL_REGISTRY:
        return

    @register_model("asrbn_tdnnf")
    def _build_asrbn(**kwargs):
        return TDNNFNet(TDNNFNetConfig(**_tuplify(kwargs)))

    @register_model("anonymizer_tdnnf_hifigan")
    def _build_anon(**kwargs):
        kwargs = dict(kwargs)
        asrbn_kwargs = _tuplify(kwargs.pop("asrbn", {}))
        return AnonymizationNet(AnonymizerConfig(asrbn=TDNNFNetConfig(**asrbn_kwargs),
                                                 **_tuplify(kwargs)))

    @register_model("asv_xvector")
    def _build_asv(**kwargs):
        from .sidekit.xvector import XVectorConfig, build_xvector

        return build_xvector(XVectorConfig(**kwargs))

    @register_model("asrbn_tdnnf_spkadv")
    def _build_spkadv(**kwargs):
        from .models.spkadv import SpkAdvTDNNFNet

        kwargs = dict(kwargs)
        num_speakers = kwargs.pop("num_speakers")
        adversarial = kwargs.pop("adversarial", True)
        return SpkAdvTDNNFNet(TDNNFNetConfig(**_tuplify(kwargs)), num_speakers=num_speakers,
                              adversarial=adversarial)

    @register_model("asrbn_tdnnf_wav2vec2")
    def _build_asrbn_w2v2(**kwargs):
        from .models.asrbn import Wav2Vec2TDNNFNet
        from .models.wav2vec2 import Wav2Vec2Config

        kwargs = dict(kwargs)
        w2v2 = Wav2Vec2Config.from_dict(kwargs.pop("wav2vec2", {}))
        return Wav2Vec2TDNNFNet(TDNNFNetConfig(**_tuplify(kwargs)), w2v2)


def serving_option_args(compute_dtype: str = "bfloat16") -> Dict[str, Any]:
    """Build-param deltas every inference entry point applies on top of a
    checkpoint's stored params: bf16 compute for generator convs and TDNNF
    matmuls."""
    return {"compute_dtype": compute_dtype}


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init of every parameter and buffer that has one."""
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(generator=g)
    return model


def build_model(model_id: str, device="cuda", seed: Optional[int] = 0,
                **build_params) -> nn.Module:
    """Registry builder -> module in eval mode on ``device``, with random
    weights from ``seed`` (``None``: from torch's global generator)."""
    dev = resolve_device(device)
    _register_builtins()
    if model_id not in MODEL_REGISTRY:
        raise KeyError(f"unknown model_id {model_id!r}; known: {sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[model_id](**build_params)
    if seed is not None:
        init_weights(model, seed)
    return model.to(dev).eval()


def load_model(path: str, option_args: Optional[Dict[str, Any]] = None,
               device="cuda") -> Tuple[nn.Module, Dict[str, Any]]:
    """Checkpoint file -> (model on ``device``, meta). ``option_args``
    override stored build params."""
    dev = resolve_device(device)
    meta, state_dict = load_checkpoint(path)
    build_params = dict(meta.get("build_params", {}))
    if option_args:
        build_params.update(option_args)
    model = build_model(meta["model_id"], device="cpu", seed=None, **build_params)
    model.load_state_dict(state_dict)
    return model.to(dev), meta


def save_model(path: str, model_id: str, build_params: Dict[str, Any],
               state_dict: Dict[str, torch.Tensor],
               extra_meta: Optional[Dict[str, Any]] = None) -> None:
    meta = {"model_id": model_id, "build_params": build_params}
    if extra_meta:
        meta.update(extra_meta)
    save_checkpoint(path, meta, state_dict)
