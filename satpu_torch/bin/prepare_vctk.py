"""VoicePrivacy VCTK eval-set preparation (offline part).

The reference's ``egs/anon/vctk/local/data_prep_vpc.sh`` turns the downloaded
``data/vctk_test`` kaldi dir (which ships side files ``enrolls_mic2`` and
``trials_{f,m}{_common,}_mic2``) into the enroll/trial subset dirs the eval
consumes. Everything after the download is pure kaldi-dir munging, done here
natively (no kaldi checkout needed):

- text normalization of the downloaded ``text`` (download_data.sh:46-50:
  strip ``,!?.``, squeeze spaces, uppercase),
- ``<dset>_enrolls``: subset by the ``enrolls_mic2`` utt list, with the list
  copied in as ``enrolls`` (data_prep_vpc.sh:36-38),
- ``<dset>_trials_{f,m}`` / ``_{f,m}_common``: subset by the utts named in
  column 2 of each ``trials_*_mic2`` file, the file copied in as ``trials``
  (data_prep_vpc.sh:40-56),
- ``<dset>_trials_{f,m}_all`` / ``_trials_all``: combined dirs with
  concatenated ``trials`` (data_prep_vpc.sh:47-62).

Usage (the day the corpus download is available):
  python -m satpu_torch.bin.prepare_vctk --data data/vctk_test
"""
from __future__ import annotations

import argparse
import logging
import os
import re
import sys

from ..utils import kaldi_data

SIDE_FILES = ("enrolls_mic2", "trials_f_common_mic2", "trials_f_mic2",
              "trials_m_common_mic2", "trials_m_mic2")


def normalize_text(path: str) -> None:
    """download_data.sh:46-50: drop ,!?. -> spaces, squeeze, uppercase."""
    table = kaldi_data.read_keyed_text(path)
    out = {}
    for utt, txt in table.items():
        txt = re.sub(r"[,!?.]", " ", txt)
        txt = re.sub(r" +", " ", txt).strip().upper()
        out[utt] = txt
    kaldi_data.write_keyed_text(out, path)


def prepare(dset: str) -> list:
    """Build all enroll/trial subset dirs next to ``dset``; returns their
    paths. ``dset`` is the downloaded data dir (e.g. data/vctk_test)."""
    missing = [f for f in SIDE_FILES
               if not os.path.exists(os.path.join(dset, f))]
    if missing:
        raise FileNotFoundError(
            f"{dset} is missing the VPC side files {missing}; these ship "
            "inside the vctk_test download (see reference "
            "egs/anon/vctk/local/download_data.sh)")
    normalize_text(os.path.join(dset, "text"))
    made = []

    # enrolls
    enrolls = [l.split()[0] for l in
               open(os.path.join(dset, "enrolls_mic2")) if l.strip()]
    d = f"{dset}_enrolls"
    kaldi_data.subset_data_dir(dset, enrolls, d)
    with open(os.path.join(dset, "enrolls_mic2")) as fi, \
            open(os.path.join(d, "enrolls"), "w") as fo:
        fo.write(fi.read())
    made.append(d)

    # per-gender trials (+ common), then the combined _all dirs
    for gender in ("f", "m"):
        parts = []
        for suffix, tag in (("", f"trials_{gender}"),
                            ("_common", f"trials_{gender}_common")):
            src_list = os.path.join(dset, f"trials_{gender}{suffix}_mic2")
            utts = sorted({l.split()[1] for l in open(src_list) if l.strip()})
            d = f"{dset}_{tag}"
            kaldi_data.subset_data_dir(dset, utts, d)
            with open(src_list) as fi, open(os.path.join(d, "trials"), "w") as fo:
                fo.write(fi.read())
            parts.append(d)
            made.append(d)
        d_all = f"{dset}_trials_{gender}_all"
        kaldi_data.combine_data_dirs(d_all, parts)
        with open(os.path.join(d_all, "trials"), "w") as fo:
            for p in parts:
                fo.write(open(os.path.join(p, "trials")).read())
        made.append(d_all)

    d_all = f"{dset}_trials_all"
    g_alls = [f"{dset}_trials_f_all", f"{dset}_trials_m_all"]
    kaldi_data.combine_data_dirs(d_all, g_alls)
    with open(os.path.join(d_all, "trials"), "w") as fo:
        for p in g_alls:
            fo.write(open(os.path.join(p, "trials")).read())
    made.append(d_all)
    return made


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="satpu_torch %(levelname)s: %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True,
                   help="downloaded VPC data dir (e.g. data/vctk_test)")
    args = p.parse_args(argv)
    made = prepare(args.data.rstrip("/"))
    for d in made:
        n = len(kaldi_data.read_keyed_text(os.path.join(d, "wav.scp")))
        logging.info("%s: %d utts", d, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
