"""One-command real-data parity runbook (port of ``satpu.bin.parity``).

Chains the whole "first day with network" flow against the reference's
published numbers: convert a released reference ``final.pt`` -> anonymize an
eval set -> run the privacy/utility eval -> print measured vs BASELINE.md
side by side. Every step is the port's own CLI (import_model / anonymize /
eval_anon, each on ``--device``, CUDA unless ``--device cpu``); this driver
only sequences them and renders the comparison.

  python -m satpu_torch.bin.parity \\
      --torch-checkpoint final.pt --tag hifigan_bn_tdnnf_wav2vec2_vq_48_v1 \\
      --data data/vctk_test_trials_all --eval-config configs/eval.ini \\
      --baseline vctk_clear

Baselines cite the reference's published tables (satpu's ``BASELINES``,
mirrored in BASELINE.md). ``--skip-anonymize`` evaluates the clear signals
(the reference's eval_clear config), which is the reproduction target for
the ``vctk_clear`` row.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

# reference-published rows (BASELINE.md); keys match results.json fields
BASELINES = {
    "vctk_clear": {  # clear VCTK eval (reference egs/anon/vctk/README.md:36-48)
        "wer": 21.97,        # with fg rescoring (26.92 without)
        "eer": 1.14, "min_cllr": 0.045, "linkability": 0.971,
        "asnorm_eer": 1.049, "asnorm_min_cllr": 0.03,
        "asnorm_linkability": 0.981,
    },
    "vpc_b5": {  # anon/anon libri test, tag hifigan_bn_tdnnf_wav2vec2_vq_48_v1
        # (reference README.md:109-121; f/m averaged for the single-list run)
        "wer": 4.369, "eer_f": 33.946, "eer_m": 34.729,
    },
    "vpc_b6": {  # tag hifigan_bn_tdnnf_600h_vq_48_v1 (README.md:127-137)
        "wer": 9.092, "eer_f": 21.146, "eer_m": 21.137,
    },
    "vpc_b5_f0t": {  # B5 + f0-transformation=quant_16_awgn_2
        # (README.md:139-152: tag hifigan_bn_tdnnf_wav2vec2_vq_48_v1
        #  +f0-transformation=quant_16_awgn_2)
        "wer": 4.814, "eer_f": 42.151, "eer_m": 40.755,
    },
    "vpc_inception": {  # single-speaker-retrained system, 600h BN
        # (README.md:154-180: tag hifigan_inception_bn_tdnnf_wav2vec2_
        #  train_600_vq_48_v1+f0-transformation=quant_16_awgn_2)
        "wer": 4.209, "eer_f": 35.765, "eer_m": 35.195,
    },
}


def _flatten_results(res: dict) -> dict:
    out = {}
    asr = res.get("asr", {})
    if "wer" in asr:
        out["wer"] = asr["wer"]
    asv = res.get("asv", {})
    for k in ("eer", "min_cllr", "linkability", "asnorm_eer",
              "asnorm_min_cllr", "asnorm_linkability"):
        if k in asv:
            out[k] = asv[k]
    return out


def print_side_by_side(measured: dict, baseline_key: str) -> None:
    base = BASELINES[baseline_key]
    print(f"\n=== parity vs reference ({baseline_key}) ===")
    print(f"{'metric':<22}{'reference':>12}{'port':>12}{'delta':>10}")
    for k, ref in base.items():
        if k in measured:
            m = measured[k]
            print(f"{k:<22}{ref:>12.3f}{m:>12.3f}{m - ref:>+10.3f}")
        else:
            print(f"{k:<22}{ref:>12.3f}{'—':>12}{'':>10}")
    extra = sorted(set(measured) - set(base))
    for k in extra:
        print(f"{k:<22}{'—':>12}{measured[k]:>12.3f}")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch-checkpoint", default="",
                   help="released reference final.pt to convert first")
    p.add_argument("--tag", default="", help="zoo tag of the anonymization pipeline")
    p.add_argument("--checkpoint", default="",
                   help="explicit anonymizer checkpoint (alternative to --tag)")
    p.add_argument("--data", required=True, help="eval data dir")
    p.add_argument("--eval-config", default="",
                   help="eval_anon INI (ASR/ASV checkpoints, graph, trials)")
    p.add_argument("--baseline", default="vctk_clear", choices=sorted(BASELINES),
                   help="which published reference row-set to print against")
    p.add_argument("--target-selection-algorithm", default="random_per_utt")
    p.add_argument("--f0-transformation", default="")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--serve-mesh", default="false")
    p.add_argument("--results", default="exp/parity")
    p.add_argument("--skip-anonymize", action="store_true",
                   help="evaluate the clear signals (reference eval_clear)")
    p.add_argument("--device", default="cuda")
    args, eval_rest = p.parse_known_args(argv)

    from . import anonymize as anonymize_cli
    from . import eval_anon as eval_cli
    from . import import_model as import_cli

    # 1. convert + install the reference checkpoint
    if args.torch_checkpoint:
        rc = import_cli.main(["--torch-checkpoint", args.torch_checkpoint, "--device",
                              args.device]
                             + (["--tag", args.tag] if args.tag else ["--out", args.checkpoint]))
        if rc != 0:
            return rc

    # 2. anonymize the eval set
    data = args.data.rstrip("/")
    if not args.skip_anonymize:
        ckpt = args.checkpoint
        if not ckpt:
            from .. import hub

            if not args.tag:
                p.error("--tag, --checkpoint, or --skip-anonymize required")
            ckpt = os.path.join(hub.zoo_dir(), hub.MODEL_ZOO[args.tag][1]
                                if args.tag in hub.MODEL_ZOO else args.tag + ".ckpt")
        anon_args = ["--checkpoint", ckpt, "--directory", data,
                     "--target-selection-algorithm", args.target_selection_algorithm,
                     "--batch-size", str(args.batch_size), "--serve-mesh", args.serve_mesh,
                     "--device", args.device]
        if args.f0_transformation:
            anon_args += ["--f0-transformation", args.f0_transformation]
        rc = anonymize_cli.main(anon_args)
        if rc != 0:
            return rc
        data = data + "_anon"

    # 3. privacy/utility eval
    os.makedirs(args.results, exist_ok=True)
    eval_args = (["--config", args.eval_config] if args.eval_config else [])
    eval_args += ["--data", data, "--results", args.results, "--serve-mesh", args.serve_mesh,
                  "--device", args.device] + eval_rest
    rc = eval_cli.main(eval_args)
    if rc != 0:
        return rc

    # 4. side-by-side vs the published reference rows
    with open(os.path.join(args.results, "results.json")) as f:
        measured = _flatten_results(json.load(f))
    print_side_by_side(measured, args.baseline)
    with open(os.path.join(args.results, "parity.json"), "w") as f:
        json.dump({"baseline": args.baseline, "reference": BASELINES[args.baseline],
                   "measured": measured}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
