"""AOT-export CLI (port of ``satpu.bin.export_model``): the reference's
``--mode jit_save`` producing ``final.jit`` (chain/model.py:167-174,
hifigan/model.py:162-171).

``torch.export`` of the anonymizer's F0 + convert (``--kind convert``) or of
an ASR-BN extractor's loglikes / ``extract_bn`` at fixed ``(batch,
num_samples)``, on ``--device`` (CUDA unless ``--device cpu``), saved as a
``.pt2`` program, the model as its checkpoint holds it (as satpu loads it).
The program runs with none of the model's code:
``satpu_torch.hub.load_exported(path)`` (it needs the ``satpu_torch::
shc_band`` and ``satpu_torch::viterbi_path`` ops registered, which that
function imports).

Usage (from the repository root):
  python -m satpu_torch.bin.export_model --checkpoint exp/hifigan/g_best.ckpt \\
      --out exp/hifigan/final.pt2 --batch 8 --num-samples 160000
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

from ..utils import config as cfg


@dataclasses.dataclass
class ExportOpts(cfg.Opts):
    checkpoint: str = ""
    out: str = ""
    kind: str = "convert"  # convert | loglikes | extract_bn
    batch: int = 8
    num_samples: int = 160000
    device: str = "cuda"


def _loglikes(model, wav):
    return model(wav)[0]


def _extract_bn(model, wav):
    return model.extract_bn(wav)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="")
    args, rest = parser.parse_known_args(argv)
    opts = ExportOpts()
    if args.config:
        ini = cfg.load_ini(args.config)
        if "export" in ini:
            opts.load_from_config(ini["export"])
    opts.load_from_args(rest)
    if not opts.checkpoint or not opts.out:
        print("need --checkpoint and --out", file=sys.stderr)
        return 2
    if opts.kind not in ("convert", "loglikes", "extract_bn"):
        raise ValueError(f"unknown kind {opts.kind!r}")

    import torch

    from .. import hub, infer_helper

    model, _ = infer_helper.load_model(opts.checkpoint, device=opts.device)
    model.eval()
    if opts.kind == "convert":
        path = hub.export_convert(model, opts.out, batch=opts.batch,
                                  num_samples=opts.num_samples)
    else:
        wav = torch.zeros((opts.batch, opts.num_samples), device=next(model.parameters()).device)
        fn = _loglikes if opts.kind == "loglikes" else _extract_bn
        path = hub.export_fn(model, fn, (wav,), opts.out)
    logging.info("exported %s (%s) -> %s", opts.checkpoint, opts.kind, path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
