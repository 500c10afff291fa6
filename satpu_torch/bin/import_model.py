"""Convert a reference torch checkpoint and install it into the zoo (port of
``satpu.bin.import_model``).

Download a released reference ``final.pt`` on any machine with network
access (hubconf.py:46-87 model zoo; ``satpu_torch.hub.reference_release_url``
gives the URL of a tag), copy it here, then:

    python -m satpu_torch.bin.import_model \\
        --torch-checkpoint final.pt --tag hifigan_bn_tdnnf_600h_vq_48_v1

converts it (``infer_helper.import_reference_checkpoint``: the architecture
inferred from the shapes, the weight-norm (g, v) pairs and the VQ codebook
carried over) into a port checkpoint under the zoo file name of that tag
(``$SATPU_ZOO``), then checks that ``satpu_torch.hub.load(tag)`` opens it
(on ``--device``, default cuda). ``hub.load`` then takes
"+f0-transformation=..." option args with no network.

``--kind`` is inferred from the tag (``asrbn`` for ``asrbn*`` / ``bn_*``,
``anonymizer`` otherwise); ``--out`` writes to an explicit path instead of
the zoo.
"""
import argparse
import logging
import os
import sys


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch-checkpoint", required=True, help="reference final.pt (torch format)")
    p.add_argument("--tag", default="", help="zoo tag to install as (satpu_torch.hub.MODEL_ZOO)")
    p.add_argument("--kind", default="", choices=["", "anonymizer", "asrbn"],
                   help="converter kind; inferred from the tag when empty")
    p.add_argument("--out", default="", help="explicit output path (skips the zoo)")
    p.add_argument("--device", default="cuda", help="where hub.load checks the tag")
    args = p.parse_args(argv)

    from .. import hub, infer_helper, resolve_device

    resolve_device(args.device)  # before anything is written
    kind = args.kind
    if not kind:
        base = args.tag or os.path.basename(args.torch_checkpoint)
        kind = "asrbn" if base.startswith(("asrbn", "bn_")) else "anonymizer"
    if args.out:
        out = args.out
    else:
        if not args.tag:
            p.error("--tag or --out required")
        if args.tag not in hub.MODEL_ZOO:
            logging.warning("tag %r not in MODEL_ZOO; installing under <zoo>/%s.ckpt",
                            args.tag, args.tag)
            fname = args.tag + ".ckpt"
        else:
            fname = hub.MODEL_ZOO[args.tag][1]
        os.makedirs(hub.zoo_dir(), exist_ok=True)
        out = os.path.join(hub.zoo_dir(), fname)

    path = infer_helper.import_reference_checkpoint(args.torch_checkpoint, out, kind=kind)
    logging.info("converted %s -> %s (kind=%s)", args.torch_checkpoint, path, kind)
    if args.tag:
        _, meta = hub.load(path if args.out else args.tag, device=args.device)
        logging.info("hub.load(%r) ok: model_id=%s build_params=%s", args.tag,
                     meta.get("model_id"), meta.get("build_params"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
