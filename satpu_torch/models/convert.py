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

The ASR-BN variants: a ``Wav2Vec2TDNNFNet``'s ``preprocessor`` tree (the
wav2vec2 front) takes HuggingFace's names, the names of
``models.wav2vec2`` (``conv_layers_{i}_conv`` -> ``conv_layers.{i}.conv``,
the group norm's ``conv_layers_0_layer_norm_{weight,bias}`` ->
``conv_layers.0.layer_norm.*``, ``feature_projection_{layer_norm,
projection}`` -> ``feature_projection.*``, ``pos_conv_embed_conv`` and
``encoder_layer_norm`` -> ``encoder.pos_conv_embed.conv`` and
``encoder.layer_norm``, ``layers_{i}`` -> ``encoder.layers.{i}`` with
``feed_forward_{intermediate,output}_dense`` -> ``feed_forward.*``); its
TDNN-F layers map as a TDNNFNet's. A ``SpkAdvTDNNFNet``'s ``acoustic``
tree maps as a TDNNFNet's under ``acoustic.``, its ``asi_trunk`` and
``asi_pool`` as an x-vector model's (below), its flax ``Dense``
``asi_emb`` (kernel [in, out]) to a linear weight [out, in], and
``asi_margin`` keeps its name.

``ng_states_from_satpu`` carries the ``ng_state`` collection of any of
these nets (the natural-gradient preconditioners, which the port keeps in
its trainer, not in the state_dict) across under the same module paths.

``from_satpu_discriminators`` carries a satpu ``MultiPeriodDiscriminator``
or ``MultiScaleDiscriminator`` across: its ``params`` (``weight_v`` /
``weight_g`` / ``bias``, and the spectral-normed scale's ``weight_orig``)
and the MSD's ``spectral`` collection (``u``, ``v``) keep their names, and
``discriminators_{i}`` / ``convs_{j}`` become ``discriminators.{i}`` /
``convs.{j}``.

``from_satpu_xvector`` does the same for an x-vector model
(``EcapaXVector`` / ``ResNetXVector``): flax scopes ``<name>_<i>``
(``block_0``, ``convs_3``, ``bns_3``, ``fc_0``, ``attention_4``,
``shortcut_1``) become ``<name>.<i>``, and every batch norm's {mean, var}
becomes running_mean / running_var. ``GruPooling``'s flax GRU cells
``gru_l<k>`` (dense ``ir iz in`` on the input, ``hr hz hn`` on the state,
kernels [in, out]) become the torch GRU's ``gru.weight_ih_l<k>`` /
``weight_hh_l<k>`` (gates r, z, n stacked, [3 out, in]) and ``bias_ih_l<k>``
/ ``bias_hh_l<k>`` (the state's r and z gates have no bias in flax: zeros).
``ChannelWiseCorrPooling``'s ``proj`` / ``proj_bias`` keep their names.
A WavLM frontend's ``preprocessor/feature_extract`` tree maps as a
wav2vec2 front does (``from_satpu_wavlm``: its attention's
``gru_rel_pos_linear`` and ``gru_rel_pos_const`` keep their names, layer
0's ``rel_attn_embed`` becomes ``rel_attn_embed.weight``) under
``preprocessor.feature_extract.``, and ``preprocessor/feature_weight``
keeps its name. ``from_satpu_pcmn`` carries an ``AdaptivePCMN``'s param
dict across by name. ``convert_sidekit`` takes a reference sidekit state_dict
(ECAPA or half-ResNet) to satpu's names, then through
``from_satpu_xvector``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LIST_SCOPE = re.compile(r"^(ups|resblocks|convs1|convs2|convs|discriminators)_(\d+)$")
_XVECTOR_SCOPE = re.compile(r"^(block|convs|bns|fc|attention|shortcut)_(\d+)$")
_GRU_CELL = re.compile(r"^gru_l(\d+)$")
_MID_LAYER = re.compile(r"^tdnnf(\d+)$")
_AFTER_LAYER = re.compile(r"^tdnnf_after(\d+)$")
_BN_STAT = {"mean": "running_mean", "var": "running_var"}
_TDNNF_SCOPES = ("tdnn", "prefinal_", "chain_output", "xent_output", "vq_bottleneck",
                 "dp_bottleneck")
_W2V_CONV = re.compile(r"^conv_layers_(\d+)_(conv|layer_norm)$")
_W2V_GROUP_NORM = re.compile(r"^conv_layers_0_layer_norm_(weight|bias)$")
_W2V_LAYER = re.compile(r"^layers_(\d+)$")
_W2V_TOP = {"feature_projection_layer_norm": "feature_projection.layer_norm",
            "feature_projection_projection": "feature_projection.projection",
            "pos_conv_embed_conv": "encoder.pos_conv_embed.conv",
            "encoder_layer_norm": "encoder.layer_norm"}


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


def _wav2vec2_key(path: Tuple[str, ...]) -> str:
    """A satpu ``Wav2Vec2Model`` param path -> the port's (HF) name."""
    head, rest = path[0], list(path[1:])
    if head == "feature_extractor":
        g = _W2V_GROUP_NORM.match(rest[0])
        if g:
            return f"feature_extractor.conv_layers.0.layer_norm.{g.group(1)}"
        m = _W2V_CONV.match(rest[0])
        return ".".join([f"feature_extractor.conv_layers.{m.group(1)}.{m.group(2)}"] + rest[1:])
    if head in _W2V_TOP:
        return ".".join([_W2V_TOP[head]] + rest)
    i = _W2V_LAYER.match(head).group(1)
    sub = {"feed_forward_intermediate_dense": "feed_forward.intermediate_dense",
           "feed_forward_output_dense": "feed_forward.output_dense"}.get(rest[0], rest[0])
    return ".".join([f"encoder.layers.{i}", sub] + rest[1:])


def from_satpu_wav2vec2(params: Mapping) -> Dict[str, torch.Tensor]:
    """satpu ``Wav2Vec2Model`` params -> ``models.wav2vec2.Wav2Vec2Model``'s
    state_dict."""
    return {_wav2vec2_key(path): _tensor(path, leaf) for path, leaf in _flatten(params)}


def _hifigan_key(path: Tuple[str, ...]) -> str:
    return ".".join(_LIST_SCOPE.sub(r"\1.\2", p) for p in path)


def _tensor(path: Tuple[str, ...], arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):  # a bf16 leaf of a satpu checkpoint
        arr = arr.float().numpy()
    a = np.array(arr, dtype=np.float32)  # a writable copy
    if path[-1] == "bias" and a.ndim == 2 and a.shape[0] == 1:
        a = a[0].copy()  # affine bias [1, out] -> [out]
    return torch.from_numpy(a)  # 0-d stays 0-d (a loss head's scalars)


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


def _n_mid(paths) -> int:
    """The number of middle TDNN-F layers ``tdnnf1..tdnnf{n}`` (the BN layer
    follows them in ``tdnnfs``)."""
    return max([int(m.group(1)) for path in paths if (m := _MID_LAYER.match(path[0]))],
               default=0)


def _spkadv_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A ``SpkAdvTDNNFNet``'s variables -> its state_dict."""
    acoustic = {coll: (variables.get(coll) or {}).get("acoustic", {})
                for coll in ("params", "batch_stats", "vq_stats")}
    out = {"acoustic." + k: v for k, v in from_satpu_variables(acoustic).items()}
    branch = {coll: {k: v for k, v in (variables.get(coll) or {}).items()
                     if k in ("asi_trunk", "asi_pool")}
              for coll in ("params", "batch_stats")}
    out.update(from_satpu_xvector(branch))
    params = variables["params"]
    out["asi_emb.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(params["asi_emb"]["kernel"], np.float32).T))
    out["asi_emb.bias"] = _tensor(("bias",), params["asi_emb"]["bias"])
    out["asi_margin.weight"] = _tensor(("weight",), params["asi_margin"]["weight"])
    return out


def from_satpu_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """satpu variables {params, batch_stats, vq_stats} -> torch state_dict."""
    if "acoustic" in (variables.get("params") or {}):
        return _spkadv_state_dict(variables)
    entries = list(_modules(variables))
    n_mid = _n_mid(path for _, kind, path, _ in entries if kind == "tdnnf")
    out = {}
    for prefix, kind, path, leaf in entries:
        if kind == "tdnnf" and path[0] == "preprocessor":  # a Wav2Vec2TDNNFNet's front
            key = "preprocessor." + _wav2vec2_key(path[1:])
        elif kind == "tdnnf":
            key = _tdnnf_key(path, n_mid)
        else:
            key = _hifigan_key(path)
        out[prefix + key] = _tensor(path, leaf)
    return out


def from_satpu_discriminators(variables: Mapping) -> Dict[str, torch.Tensor]:
    """satpu MPD / MSD variables {params, spectral} -> torch state_dict."""
    return {_hifigan_key(path): _tensor(path, leaf)
            for coll in ("params", "spectral")
            for path, leaf in _flatten(variables.get(coll) or {})}


def _gru_tensors(prefix: str, layer: str, cell: Mapping) -> Dict[str, torch.Tensor]:
    """One flax GRU cell's dense layers -> the torch GRU's layer ``layer``."""
    def kernel(g):
        return np.asarray(cell[g]["kernel"], np.float32).T

    zeros = np.zeros_like(np.asarray(cell["hn"]["bias"], np.float32))
    arrays = {f"weight_ih_l{layer}": np.concatenate([kernel(g) for g in ("ir", "iz", "in")]),
              f"weight_hh_l{layer}": np.concatenate([kernel(g) for g in ("hr", "hz", "hn")]),
              f"bias_ih_l{layer}": np.concatenate([cell[g]["bias"] for g in ("ir", "iz", "in")]),
              f"bias_hh_l{layer}": np.concatenate([zeros, zeros, cell["hn"]["bias"]])}
    return {prefix + "gru." + k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in arrays.items()}


def _wavlm_key(path: Tuple[str, ...]) -> str:
    """A satpu ``WavLMModel`` param path -> the port's (HF) name: the
    wav2vec2 map, and the bucket embedding's leaf as an embedding weight."""
    key = _wav2vec2_key(path)
    return key + ".weight" if path[-1] == "rel_attn_embed" else key


def from_satpu_wavlm(params: Mapping) -> Dict[str, torch.Tensor]:
    """satpu ``WavLMModel`` params -> ``models.wavlm.WavLMModel``'s
    state_dict."""
    return {_wavlm_key(path): _tensor(path, leaf) for path, leaf in _flatten(params)}


def from_satpu_xvector(variables: Mapping) -> Dict[str, torch.Tensor]:
    """satpu x-vector variables {params, batch_stats} -> torch state_dict."""
    out = {}
    for coll in ("params", "batch_stats"):
        cells: Dict[Tuple[str, ...], Dict] = {}
        for path, leaf in _flatten(variables.get(coll) or {}):
            if path[0] == "preprocessor":  # the WavLM frontend
                key = ("preprocessor.feature_weight" if path[1] == "feature_weight" else
                       "preprocessor.feature_extract." + _wavlm_key(path[2:]))
                out[key] = _tensor(path, leaf)
                continue
            *scopes, name = path
            gru = [i for i, p in enumerate(scopes) if _GRU_CELL.match(p)]
            if gru:  # a GruPooling cell: gathered, then stacked below
                i = gru[0]
                cell = cells.setdefault(tuple(scopes[:i + 1]), {})
                cell.setdefault(scopes[i + 1], {})[name] = leaf
                continue
            if coll == "batch_stats":
                name = _BN_STAT[name]
            key = ".".join([_XVECTOR_SCOPE.sub(r"\1.\2", p) for p in scopes] + [name])
            out[key] = _tensor(path, leaf)
        for scopes, cell in cells.items():
            prefix = "".join(p + "." for p in scopes[:-1])
            out.update(_gru_tensors(prefix, _GRU_CELL.match(scopes[-1]).group(1), cell))
    return out


def _sidekit_scopes(parts, arch: str) -> Tuple[str, ...]:
    """A reference sidekit module path -> satpu's flax scopes (satpu's
    ``convert_sidekit``): ``before_speaker_embedding.<name>`` flattens to
    ``before_speaker_embedding_<name>``; an index under ECAPA's
    ``layer2``-``layer4`` becomes ``block_<i>``, under a ResNet stage
    ``layer<k>`` it stays ``<i>``, and elsewhere ``<name>.<i>`` becomes
    ``<name>_<i>``."""
    path = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if p == "before_speaker_embedding" and nxt is not None:
            path.append(f"before_speaker_embedding_{nxt}")
        elif nxt is not None and nxt.isdigit():
            if arch == "ecapa" and p in ("layer2", "layer3", "layer4"):
                path += [p, f"block_{nxt}"]
            elif p.startswith("layer") and arch != "ecapa":
                path += [p, nxt]
            else:
                path.append(f"{p}_{nxt}")
        else:
            path.append(p)
            i += 1
            continue
        i += 2
    return tuple(path)


def convert_sidekit(sd: Mapping[str, Any], arch: str = "ecapa") -> Dict[str, torch.Tensor]:
    """A reference sidekit ECAPA (``arch="ecapa"``) or half-ResNet state_dict
    -> the port's x-vector state_dict: ``from_satpu_xvector`` of satpu's
    ``convert_sidekit`` (``satpu/models/convert.py:141-188``). The
    preprocessor and spec_augment buffers and ``num_batches_tracked`` are
    dropped, the running statistics kept, the reference's
    ``before_speaker_embedding`` Sequential maps onto the
    ``before_speaker_embedding_*`` modules, and Sequential indices onto the
    port's module paths."""
    variables: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for k, t in sd.items():
        parts = k.split(".")
        if k.startswith(("preprocessor.", "spec_augment.")) or parts[-1] == "num_batches_tracked":
            continue
        arr = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
               else np.asarray(t)).astype(np.float32)
        leaf = parts[-1]
        coll = "batch_stats" if leaf in ("running_mean", "running_var") else "params"
        node = variables[coll]
        for p in _sidekit_scopes(parts[:-1], arch):
            node = node.setdefault(p, {})
        node[{"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)] = arr
    return from_satpu_xvector(variables)


def from_satpu_pcmn(params: Mapping) -> Dict[str, torch.Tensor]:
    """satpu ``AdaptivePCMN.init``'s param dict -> ``ops.cmvn.AdaptivePCMN``'s
    state_dict (the same names and layouts)."""
    return {k: _tensor((k,), v) for k, v in params.items()}


def ng_states_from_satpu(ng_state: Mapping) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """satpu's per-layer ``ng_state`` tree ({..layer..: {"in"|"out": {W, d,
    rho, t, nrows}}}) of a TDNNFNet, Wav2Vec2TDNNFNet or SpkAdvTDNNFNet ->
    {module path: {"in"|"out": {W, d, rho, t}}}, the layout of
    ``satpu_torch.chain.trainer.ChainTrainer.ng_states``."""
    entries = list(_flatten(ng_state))
    # a SpkAdvTDNNFNet holds its TDNN-F under `acoustic`
    prefix = "acoustic." if entries and entries[0][0][0] == "acoustic" else ""
    entries = [(path[1:] if prefix else path, leaf) for path, leaf in entries]
    n_mid = _n_mid(path for path, _ in entries)
    out: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
    for path, leaf in entries:
        *module, side, key = path
        if key == "nrows":  # a statistics carrier of satpu's custom_vjp
            continue
        name = prefix + _tdnnf_key(tuple(module) + ("_",), n_mid)[:-2]
        out.setdefault(name, {}).setdefault(side, {})[key] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
    return out
