"""``anonymize`` CLI over kaldi-style data dirs (port of ``satpu.bin.anonymize``).

Config: INI with ``${:var}`` interpolation, an ``[anonymize]`` section with
the same keys as the flags. Runs on ``--device`` (default ``cuda``; raises
when CUDA is absent unless ``--device cpu`` is given). ``--num-procs N``
runs the dir as N shard processes (``--num-shards N --shard k``, the same
other arguments, so all on ``--device``), as the reference forks a process
per job (bin/anonymize:82-93); when one fails the others are terminated
and the run exits non-zero. ``--serve-mesh true`` splits every batch over
every local card, one replica of the model on each (satpu's serving mesh;
``batch_size`` a multiple of the card count); on one card it runs
unsharded.

Usage:
  python -m satpu_torch.bin.anonymize --checkpoint model.pt --directory data/X
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

from ..utils import config as cfg


@dataclasses.dataclass
class AnonymizeOpts(cfg.Opts):
    checkpoint: str = ""
    directory: str = ""
    results_dir: str = ""
    target_selection_algorithm: str = "constant"
    target_constant_spkid: str = ""
    f0_transformation: str = ""
    batch_size: int = 32
    new_datadir_suffix: str = "_anon"
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    # local process fan-out: num_procs shard processes, fail-fast
    num_procs: int = 1
    # serving compute dtype override
    compute_dtype: str = "bfloat16"
    # batches split over every local card (the serving mesh)
    serve_mesh: bool = False
    device: str = "cuda"


def run_shards(argv, num_procs: int) -> int:
    """The command line ``argv`` as ``num_procs`` shard processes of this
    CLI (``--num-procs`` dropped; ``--num-shards`` / ``--shard`` appended,
    so they override), fail-fast. Returns 0, or the first shard's positive
    return code (the siblings it took down return a signal's negative
    one; 1 when every failure was a signal)."""
    from ..utils.jobs import run_parallel_failfast

    base, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a.startswith("--num-procs"):
            skip = "=" not in a
        else:
            base.append(a)
    cmds = [[sys.executable, "-m", "satpu_torch.bin.anonymize", *base,
             "--num-shards", str(num_procs), "--shard", str(k)] for k in range(num_procs)]
    # the children import this package from any working directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    rcs = run_parallel_failfast(cmds, env=env)
    if all(rc == 0 for rc in rcs):
        return 0
    logging.error("shard return codes %s", rcs)
    return next((rc for rc in rcs if rc > 0), 1)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="", help="INI config path")
    args, rest = parser.parse_known_args(argv)

    opts = AnonymizeOpts()
    if args.config:
        ini = cfg.load_ini(args.config)
        if "anonymize" in ini:
            opts.load_from_config(ini["anonymize"])
    opts.load_from_args(rest)

    if not opts.checkpoint or not opts.directory:
        print("need --checkpoint and --directory", file=sys.stderr)
        return 2
    if opts.num_procs > 1:
        return run_shards(argv if argv is not None else sys.argv[1:], opts.num_procs)
    from .. import infer_helper, resolve_device
    from ..parallel.mesh import serve_devices
    from .pipeline import process_data

    devices = serve_devices(resolve_device(opts.device)) if opts.serve_mesh else None
    if devices and len(devices) > 1 and opts.batch_size % len(devices):
        raise ValueError(f"serve_mesh needs batch_size ({opts.batch_size}) divisible by the "
                         f"device count ({len(devices)})")

    model, meta = infer_helper.load_model(
        opts.checkpoint, option_args=infer_helper.serving_option_args(
            opts.compute_dtype or "bfloat16"), device=opts.device)
    speakers = meta.get("speakers") or [str(i) for i in range(model.cfg.num_speakers)]
    results_dir = opts.results_dir or os.path.join(
        opts.directory.rstrip("/") + opts.new_datadir_suffix, "wavs")

    def progress(done, total):
        if done % 50 < opts.batch_size or done == total:
            logging.info("progress: %d/%d", done, total)

    out_dir = process_data(
        model, speakers, opts.directory, results_dir,
        target_selection_algorithm=opts.target_selection_algorithm,
        target_constant_spkid=opts.target_constant_spkid,
        batch_size=opts.batch_size, f0_transformation=opts.f0_transformation,
        seed=opts.seed, new_datadir_suffix=opts.new_datadir_suffix,
        num_shards=opts.num_shards, shard=opts.shard,
        f0_speaker_stats=meta.get("f0_speaker_stats"), devices=devices, progress_cb=progress)
    logging.info("done: %s", out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
