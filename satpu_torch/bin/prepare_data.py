"""Chain data preparation without Kaldi (port of ``satpu.bin.prepare_data``;
numpy only, on the host).

From a kaldi-style data dir (wav.scp, text, utt2spk [, a lexicon]) it writes
everything ``satpu_torch.bin.train_asr`` reads: speed-perturbed egs snapped
to allowed lengths, per-utterance numerator FSTs (train and valid),
den.fst, normalization.fst, tree.json, phones.txt, num_pdfs, and the
HCLG.fst / words.txt that ``eval_anon`` decodes with. The files are satpu's
bytes for the same inputs.

Usage (from the repository root):
  python -m satpu_torch.bin.prepare_data --config egs/asr/librispeech/configs/prepare_data.ini
  python -m satpu_torch.bin.prepare_data --data-dir data/train --out-dir exp/chain_prep \\
      [--lexicon data/lexicon.txt]
Then:
  python -m satpu_torch.bin.train_asr --train-set exp/chain_prep/egs \\
      --fst-scp exp/chain_prep/fst_train.scp --den-fst exp/chain_prep/den.fst \\
      --normalization-fst exp/chain_prep/normalization.fst \\
      --num-pdfs $(cat exp/chain_prep/num_pdfs)
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

from ..utils import config as cfg


@dataclasses.dataclass
class PrepareDataOpts(cfg.Opts):
    data_dir: str = ""
    out_dir: str = ""
    lexicon: str = ""
    num_lengths: int = 12
    biphone: bool = True
    speed_perturb: bool = True
    between_silprob: float = 0.1
    valid_fraction: float = 0.05
    seed: int = 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="")
    args, rest = parser.parse_known_args(argv)
    opts = PrepareDataOpts()
    if args.config:
        ini = cfg.load_ini(args.config)
        if "prepare_data" in ini:
            opts.load_from_config(ini["prepare_data"])
    opts.load_from_args(rest)
    if not opts.data_dir or not opts.out_dir:
        print("need --data-dir and --out-dir", file=sys.stderr)
        return 2

    from ..chain.prep import prepare_chain_data

    out = prepare_chain_data(
        opts.data_dir, opts.out_dir, lexicon_path=opts.lexicon or None,
        num_lengths=opts.num_lengths, biphone=opts.biphone,
        between_silprob=opts.between_silprob, valid_fraction=opts.valid_fraction,
        speed_perturb=opts.speed_perturb, seed=opts.seed)
    logging.info("prepared: num_pdfs=%d egs=%s", out["num_pdfs"], out["egs_dir"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
