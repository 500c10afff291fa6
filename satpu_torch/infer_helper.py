"""Model registry + self-describing checkpoint loading (port of
``satpu.infer_helper``).

Checkpoints carry a ``model_id`` resolved through a registry of builders
(``asrbn_tdnnf``, ``asrbn_tdnnf_spkadv`` with ``num_speakers`` /
``adversarial``, ``asrbn_tdnnf_wav2vec2`` with its ``wav2vec2`` config dict,
``anonymizer_tdnnf_hifigan``, ``asv_xvector`` with its ``wavlm`` config
dict) plus the JSON build params; ``load_model`` rebuilds the module on the
requested device (CUDA by default) and loads its weights. It reads the
port's ``torch.save`` checkpoints and satpu's flax-msgpack ones (told apart
by the file's first bytes; satpu's variables go through
``models.convert``'s bridge).

``import_reference_checkpoint`` converts a reference torch ``final.pt``
(``base_model_state_dict`` + ``base_model_params``) into a port
checkpoint, inferring the architecture from the tensors' shapes as satpu
does.
"""
from __future__ import annotations

import logging
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from . import resolve_device
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.flax_msgpack import is_satpu_checkpoint, load_satpu_checkpoint

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


def _satpu_state_dict(model_id: str, variables) -> Dict[str, torch.Tensor]:
    """A satpu checkpoint's variables -> the port's state_dict."""
    from .models.convert import from_satpu_variables, from_satpu_xvector

    if model_id == "asv_xvector":
        return from_satpu_xvector(variables)
    return from_satpu_variables(variables)


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """A port or satpu checkpoint -> (meta, the port's state_dict on the CPU)."""
    if not is_satpu_checkpoint(path):
        return load_checkpoint(path)
    meta, state = load_satpu_checkpoint(path)
    return meta, _satpu_state_dict(meta["model_id"], state.get("variables", state))


def load_model(path: str, option_args: Optional[Dict[str, Any]] = None,
               device="cuda", load_weight: bool = True) -> Tuple[nn.Module, Dict[str, Any]]:
    """Checkpoint file (the port's or satpu's) -> (model on ``device``,
    meta). ``option_args`` override stored build params. With
    ``load_weight=False`` the model is built from the file's meta and the
    option args alone: its weights are ``build_model``'s seeded init,
    not the file's.

    satpu creates a module's parameters when it first runs, so its
    checkpoint of a model initialized through one method (an anonymizer
    through ``convert``) lacks the modules that method never ran (the
    extractor's chain / xent heads): those keep the builder's init, and
    are logged. Every tensor the checkpoint holds must load."""
    dev = resolve_device(device)
    meta, state_dict = read_checkpoint(path)
    build_params = dict(meta.get("build_params", {}))
    if option_args:
        build_params.update(option_args)
    if not load_weight:
        return build_model(meta["model_id"], device=dev, **build_params), meta
    model = build_model(meta["model_id"], device="cpu", seed=None, **build_params)
    satpu = is_satpu_checkpoint(path)
    missing, unexpected = model.load_state_dict(state_dict, strict=not satpu)
    if unexpected:
        raise KeyError(f"{path}: {len(unexpected)} tensors the {meta['model_id']} does not "
                       f"hold, e.g. {unexpected[:3]}")
    if missing:
        logging.info("%s: %d tensors the satpu model never created keep their init "
                     "(e.g. %s)", path, len(missing), missing[0])
    return model.to(dev), meta


def save_model(path: str, model_id: str, build_params: Dict[str, Any],
               state_dict: Dict[str, torch.Tensor],
               extra_meta: Optional[Dict[str, Any]] = None) -> None:
    meta = {"model_id": model_id, "build_params": build_params}
    if extra_meta:
        meta.update(extra_meta)
    save_checkpoint(path, meta, state_dict)


# ---------------------------------------------------------------------------
# Reference torch checkpoints (final.pt)
# ---------------------------------------------------------------------------

# the reference's TDNN-F Sequentials interleave a Dropout after every layer
_REF_LAYER = re.compile(r"\b(tdnnfs|tdnnfs_after)\.(\d+)\.")
_REF_VQ = {"quant._embedding.weight": "vq.embedding",
           "quant._ema_cluster_size": "vq.ema_cluster_size", "quant._ema_w": "vq.ema_w"}
# the BN layer of the reference's 12-layer stage (tdnnfs.20 there)
_REF_BN_LAYER = "tdnnfs.20."


def _reference_key(key: str) -> str:
    """A reference TDNN-F or generator key -> the port's: Sequential index
    2k -> k, the VQ's ``quant._*`` buffers -> ``vq.*``."""
    key = _REF_LAYER.sub(lambda m: f"{m.group(1)}.{int(m.group(2)) // 2}.", key)
    for old, new in _REF_VQ.items():
        if key.endswith("bottleneck_func." + old):
            return key[:-len(old)] + new
    return key


def _reference_asrbn_params(sd: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """TDNNFNetConfig build params the reference state_dict's shapes fix
    (output_dim, the VQ codebook), as satpu infers them."""
    p: Dict[str, Any] = {}
    w = sd.get(prefix + "chain_output.weight")
    if w is not None:
        p["output_dim"] = int(w.shape[0])
    vq = sd.get(prefix + _REF_BN_LAYER + "tdnn.bottleneck_func.quant._embedding.weight")
    if vq is not None:
        p["bottleneck"] = "vq"
        p["codebook_size"] = int(vq.shape[0])
    return p


def import_reference_checkpoint(torch_ckpt_path: str, out_path: str,
                                kind: str = "anonymizer") -> str:
    """Convert a reference torch checkpoint (``final.pt``: a
    ``base_model_state_dict`` and ``base_model_params``, chain/model.py:
    442-460) into a port checkpoint at ``out_path``.

    ``kind="anonymizer"``: an ``anonymizer_tdnnf_hifigan`` whose
    ``num_speakers`` (conv_pre's input width less bn_dim + 1; 247 when
    none), ``upsample_initial_channel``, ``bn_dim`` (the BN layer's
    linearA input) and extractor (output_dim, VQ codebook) come from the
    shapes, its speaker table from ``utt2spk``; ``kind="asrbn"``: an
    ``asrbn_tdnnf`` (output_dim from ``base_model_params`` or the shapes,
    3280 by default). The other widths are the configs' defaults, as in
    satpu (``satpu/infer_helper.py:127-192``)."""
    blob = torch.load(torch_ckpt_path, map_location="cpu", weights_only=False)
    sd = blob.get("base_model_state_dict", blob)
    params_meta = blob.get("base_model_params", {})
    if kind == "anonymizer":
        spk = sorted(set(params_meta.get("utt2spk", {}).values()))
        bnw = sd.get("bn_extractor." + _REF_BN_LAYER + "tdnn.linearA.weight")
        bn_dim = int(bnw.shape[1]) if bnw is not None else None
        build_params: Dict[str, Any] = {}
        num_speakers = len(spk)
        pre = sd.get("hifigan.conv_pre.weight_v")
        if pre is not None:
            # input_dim = bn_dim + 1 (f0) + num_speakers (tuning/hifigan.py:45)
            num_speakers = int(pre.shape[1]) - (bn_dim or 256) - 1
            build_params["upsample_initial_channel"] = int(pre.shape[0])
        build_params["num_speakers"] = num_speakers or 247
        if bn_dim is not None:
            build_params["bn_dim"] = bn_dim
        asrbn = _reference_asrbn_params(sd, "bn_extractor.")
        if asrbn:
            build_params["asrbn"] = asrbn
        extra, model_id = {"speakers": spk}, "anonymizer_tdnnf_hifigan"
    elif kind == "asrbn":
        build_params = {"output_dim": params_meta.get("output_dim", 3280)}
        build_params.update(_reference_asrbn_params(sd))
        extra, model_id = {}, "asrbn_tdnnf"
    else:
        raise ValueError(kind)
    want = build_model(model_id, device="cpu", seed=None, **build_params).state_dict()
    ported = {_reference_key(k): v for k, v in sd.items()}
    bad = sorted(k for k in want if k not in ported or ported[k].shape != want[k].shape)
    if bad:
        raise KeyError(f"{torch_ckpt_path} lacks {len(bad)} tensors of the {model_id} its "
                       f"shapes describe (or holds them in other shapes), e.g. {bad[:3]}")
    state = {k: ported[k].detach().to(torch.float32).clone() for k in want}
    save_model(out_path, model_id, build_params, state, extra_meta=extra)
    return out_path
