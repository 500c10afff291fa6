"""Model distribution: the torch.hub analog and the AOT export (port of
``satpu.hub``).

The reference resolves a tag to a GitHub-release checkpoint
(``torch.hub.load(..., "anonymization", tag_version=...)``, hubconf.py:
13-114). Here ``load(tag_or_path)`` resolves a tag through ``MODEL_ZOO``
to a file under the zoo dir (``$SATPU_ZOO`` or ``~/.cache/satpu``),
downloading it from the recorded URL when it is absent (no tag records one
yet, so a missing file raises), then calls ``infer_helper.load_model``;
``tag+key=value`` option args override build params as the reference's
``"tag+f0-transformation=..."`` strings do (hubconf.py:32-44).

Without network, convert a reference release into the zoo with
``python -m satpu_torch.bin.import_model --torch-checkpoint final.pt --tag
<tag>`` (``final.pt`` from ``reference_release_url(tag)``). A zoo file
may be a port checkpoint or a satpu one: ``load_model`` reads both.

``export_convert`` / ``export_fn`` write a frozen program (``final.jit``'s
analog): ``torch.export`` of the anonymizer's F0 + convert (or of an
extractor's ``loglikes`` / ``extract_bn``) at fixed shapes, saved as a
``.pt2`` file; ``load_exported`` runs it with none of the model's code.
YAAPT's SHC band and its two Viterbi DPs are the registered ops
``satpu_torch::shc_band`` and ``satpu_torch::viterbi_path`` in the program
(their kernels on the card), so loading needs those ops registered:
``import satpu_torch.ops.yaapt`` first. satpu's StableHLO export runs with
plain jax instead.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from . import infer_helper, resolve_device

# every released reference tag (hubconf.py:46-87 anonymization + asr_bn
# lists, plus the inception model of README.md:149-180)
_REF_TAGS = (
    # anonymization pipelines (hubconf.py:70-87)
    "hifigan_bn_tdnnf_wav2vec2_vq_48_v1",      # VPC-B5 flagship
    "hifigan_bn_tdnnf_wav2vec2_100h_aug_v1",
    "hifigan_bn_tdnnf_600h_aug_v1",
    "hifigan_bn_tdnnf_600h_vq_48_v1",          # VPC-B6
    "hifigan_bn_tdnnf_100h_vq_64_v1",
    "hifigan_bn_tdnnf_100h_vq_256_v1",
    "hifigan_bn_tdnnf_100h_aug_v1",
    "hifigan_inception_bn_tdnnf_wav2vec2_train_600_vq_48_v1",  # README.md:149
    # ASR-BN extractors (hubconf.py:46-66)
    "bn_tdnnf_wav2vec2_vq_48_v1",
    "bn_tdnnf_wav2vec2_100h_aug_v1",
    "bn_tdnnf_600h_aug_v1",
    "bn_tdnnf_600h_vq_48_v1",
    "bn_tdnnf_100h_vq_64_v1",
    "bn_tdnnf_100h_vq_256_v1",
    "bn_tdnnf_100h_aug_v1",
)
# tag -> (url, file name under the zoo dir); no URL is hosted yet
MODEL_ZOO: Dict[str, Tuple[str, str]] = {tag: ("", tag + ".ckpt") for tag in _REF_TAGS}
# satpu's own: the ASV eval model trained by egs/asv/voxceleb
MODEL_ZOO["asv_eval_vox1_ecapa_tdnn"] = ("", "asv_eval_vox1_ecapa_tdnn.ckpt")


def reference_release_url(tag: str) -> str:
    """GitHub-release URL of the reference torch ``final.pt`` for a tag
    (hubconf.py:42-44): the file goes through ``import_model``, not
    ``resolve``."""
    base, _ = _parse_option_args(tag)
    if base not in MODEL_ZOO or base == "asv_eval_vox1_ecapa_tdnn":
        raise KeyError(f"no reference release for tag {base!r}")
    return ("https://github.com/deep-privacy/SA-toolkit/releases/download/"
            f"{base}/final.pt")


def zoo_dir() -> str:
    return os.environ.get("SATPU_ZOO", os.path.join(os.path.expanduser("~"), ".cache", "satpu"))


def _parse_option_args(tag: str) -> Tuple[str, Dict[str, Any]]:
    """"tag+f0-transformation=quant_16+x=1" -> (tag, {"f0_transformation":
    "quant_16", "x": "1"}) (hubconf.py:32-44); a part without "=" is
    dropped."""
    parts = tag.split("+")
    opts: Dict[str, Any] = {}
    for kv in parts[1:]:
        if "=" in kv:
            k, v = kv.split("=", 1)
            opts[k.replace("-", "_")] = v
    return parts[0], opts


def resolve(tag: str) -> str:
    """Tag (or an existing path) -> local checkpoint path, downloading it
    when a URL is recorded."""
    if os.path.exists(tag):
        return tag
    base, _ = _parse_option_args(tag)
    if base not in MODEL_ZOO:
        raise KeyError(f"unknown model tag {base!r}; known: {sorted(MODEL_ZOO)}")
    url, fname = MODEL_ZOO[base]
    path = os.path.join(zoo_dir(), fname)
    if not os.path.exists(path):
        if not url:
            raise FileNotFoundError(
                f"{path} not found and tag {base!r} has no recorded URL; place the converted "
                "checkpoint there (python -m satpu_torch.bin.import_model)")
        import urllib.request

        os.makedirs(zoo_dir(), exist_ok=True)
        urllib.request.urlretrieve(url, path + ".tmp")
        os.replace(path + ".tmp", path)
    return path


def load(tag_or_path: str, device="cuda", load_weight: bool = True):
    """torch.hub.load analog: tag (with +option args) or path -> (model on
    ``device``, meta); ``load_weight=False`` leaves the weights at
    ``build_model``'s seeded init (``infer_helper.load_model``)."""
    resolve_device(device)
    base, opts = _parse_option_args(tag_or_path)
    path = resolve(tag_or_path if os.path.exists(tag_or_path) else base)
    return infer_helper.load_model(path, option_args=opts or None, device=device,
                                   load_weight=load_weight)


# ---------------------------------------------------------------------------
# AOT export (final.jit analog)
# ---------------------------------------------------------------------------


class _Fn(torch.nn.Module):
    """A function of a model as the module ``torch.export`` traces."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def export_fn(model: torch.nn.Module, fn, example_args, path: str) -> str:
    """``torch.export`` of ``fn(model, *example_args)`` at the examples'
    shapes, saved to ``path`` (a ``.pt2`` file)."""
    program = torch.export.export(_Fn(model, fn), tuple(example_args), strict=False)
    torch.export.save(program, path)
    return path


def load_exported(path: str):
    """Load an exported program; returns a callable module (it runs with
    none of the model's code). The ``satpu_torch::shc_band`` and
    ``satpu_torch::viterbi_path`` ops must be registered: this function
    imports their registration."""
    from .ops import yaapt  # noqa: F401  registers the satpu_torch:: ops

    return torch.export.load(path).module()


def _convert(model, wav, tid):
    return model.convert(wav, model.get_f0(wav), tid)


def export_convert(model, path: str, batch: int = 1, num_samples: int = 160000) -> str:
    """AOT-export the anonymizer's fused F0 + convert for fixed (batch,
    num_samples) on the model's device (chain/model.py:167-174 jit_save
    analog)."""
    device = next(model.parameters()).device
    wav = torch.zeros((batch, num_samples), device=device)
    tid = torch.zeros((batch,), dtype=torch.int64, device=device)
    return export_fn(model, _convert, (wav, tid), path)
