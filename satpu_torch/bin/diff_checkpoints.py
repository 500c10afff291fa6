"""Diff the weights of two checkpoints (port of ``satpu.bin.diff_checkpoints``;
reference egs/asr/librispeech/shutil/diff_models_weights.py): shape-match
the two tensor sets, then report per-tensor allclose / summed difference,
in satpu's lines. A checkpoint is the port's (``torch.save``, flat
state_dict names) or satpu's (``.ckpt``, read without flax or msgpack; its
variables tree flattened to satpu's dotted names).

Usage:
    python -m satpu_torch.bin.diff_checkpoints a.ckpt b.ckpt [--atol 1e-12]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    out[prefix.rstrip(".")] = np.asarray(tree)
    return out


def read_tensors(path: str):
    """{name: array} of a port or satpu checkpoint."""
    from ..utils.checkpoint import load_checkpoint
    from ..utils.flax_msgpack import is_satpu_checkpoint, load_satpu_checkpoint

    if is_satpu_checkpoint(path):
        _, state = load_satpu_checkpoint(path)
        return flatten(state.get("variables", state))
    _, sd = load_checkpoint(path)
    return {k: v.detach().float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in sd.items()}


def diff_checkpoints(path_a: str, path_b: str, atol: float = 1e-12,
                     skip_batchnorm: bool = True, out=None) -> int:
    """Prints one line per comparable tensor (to ``out``, standard output
    when None); returns the count of tensors that differ beyond atol."""
    out = out if out is not None else sys.stdout
    fa, fb = read_tensors(path_a), read_tensors(path_b)
    n_diff = 0
    for name in sorted(fa):
        if skip_batchnorm and ("batch_stats" in name or ".bn." in name):
            continue
        if name not in fb or fb[name].shape != fa[name].shape:
            print(f"INCOMPATIBLE\t{name}\t{fa[name].shape} vs "
                  f"{fb[name].shape if name in fb else 'missing'}", file=out)
            n_diff += 1
            continue
        same = np.allclose(fa[name], fb[name], atol=atol)
        delta = float(np.sum(fa[name] - fb[name]))
        print(f"{same}\t{name}\t sum-delta {delta:+.6g}", file=out)
        if not same:
            n_diff += 1
    return n_diff


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint_a")
    parser.add_argument("checkpoint_b")
    parser.add_argument("--atol", type=float, default=1e-12)
    parser.add_argument("--keep-batchnorm", action="store_true",
                        help="also compare batch-norm running stats")
    args = parser.parse_args(argv)
    n = diff_checkpoints(args.checkpoint_a, args.checkpoint_b, atol=args.atol,
                         skip_batchnorm=not args.keep_batchnorm)
    print(f"{n} tensors differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
