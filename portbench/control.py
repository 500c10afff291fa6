"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

For every seed, in one process: the sound program's reading of each number
compared (its output of the checked sample, or its first steps), the
control's (the plain reference in the precision one step below the
configuration's, put in the program's place) and, for a training cell,
each planted fault's (the reference with half of every batch left out;
a state left unchanged reads 1 by construction). One JSON line a seed.
Needs the card, as a run does.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def serve_readings(ctx, drv) -> dict:
    """Besides the program and the control, ``alt``: the bfloat16 reference
    with its convolutions off cuDNN, a sound run that sums in another order
    (the lower reading's witness for a program that is not bitwise the
    reference); each side's per-utterance gaps and the bfloat16 units are
    kept under ``per_utterance``, and each reference's unused codes."""
    torch, dev, cfg = ctx.torch, ctx.device, ctx.cell.config
    model, w = drv.build_program(torch, cfg, ctx.seed, dev)
    corpus = drv.Corpus(torch, ctx.cell.traffic, ctx.seed, dev)
    utts = drv.sample(ctx.cell.traffic, corpus, ctx.seed)
    where = corpus.where()
    got = []
    with torch.inference_mode():
        for u in utts:  # the timed path's call on the whole padded batch
            k, r = where[u]
            b = corpus.batches[k]
            wav = torch.from_numpy(b["wav"]).to(dev)
            out = model.convert(wav, model.get_f0(wav), torch.from_numpy(b["tid"]).to(dev))
            got.append(out[r, :corpus.lengths[u]].double().cpu())
    del model
    codes, codes32 = [], []
    want = drv.reference_outputs(torch, cfg, corpus, w, dev, utts, cfg["precision"],
                                 codes=codes)
    exact = drv.reference_outputs(torch, cfg, corpus, w, dev, utts, codes=codes32)
    sides = {"program": got,
             "control": drv.reference_outputs(torch, cfg, corpus, w, dev, utts,
                                              lower=cfg["control"]),
             "alt": drv.reference_outputs(torch, cfg, corpus, w, dev, utts, cfg["precision"],
                                          cudnn=False)}

    read = {side: drv.readings(out, want, exact) for side, out in sides.items()}
    out = {k: {side: read[side][k] for side in read} for k in read["program"]}
    size = cfg["build"]["asrbn"]["codebook_size"]
    unused = drv.codes_unused(codes, size)  # a reading of the weights, alike on both sides
    out["vq_codes_unused"] = {"program": unused, "control": unused,
                              "f32": drv.codes_unused(codes32, size)}
    out["per_utterance"] = {side: drv.per_utterance(o, want, exact)[0] for side, o in sides.items()}
    out["per_utterance"]["unit"] = drv.per_utterance(want, want, exact)[1]
    out["per_utterance"]["code_flips_f32"] = [int((a != b).sum()) for a, b in zip(codes, codes32)]
    return out


def chain_readings(ctx, drv) -> dict:
    torch, dev, cfg = ctx.torch, ctx.device, ctx.cell.config
    root = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        data = drv.ChainData(torch, cfg, ctx.cell.traffic, ctx.seed, dev, root)
        prog = drv.Program(ctx, data)
        mine, checked = prog.set_up(drv.CHECK_STEPS)
        w0, ng0, lr_at = prog.w0, prog.ng0, prog.lr_at
        del prog
        ref = drv.reference_steps(torch, cfg, data, checked, w0, ng0, ctx.seed, lr_at, dev)
        sides = {"program": mine,
                 "control": drv.reference_steps(torch, cfg, data, checked, w0, ng0, ctx.seed,
                                                lr_at, dev, lower=cfg["control"]),
                 "half_batch": drv.reference_steps(torch, cfg, data, checked, w0, ng0,
                                                   ctx.seed, lr_at, dev, half=True)}
        read = {side: drv.gaps(r, ref) for side, r in sides.items()}
        return {k: {side: read[side][k] for side in sides} for k in read["program"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    cell = harness.Cell(harness.benchmark(), args.workload)
    drv = cell.job()
    ctx = type("Context", (), {})()
    ctx.cell, ctx.torch, ctx.device, ctx.trace = cell, torch, torch.device("cuda", 0), False
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx.seed, ctx.t_start = seed, time.perf_counter()
        fn = serve_readings if cell.config["job"] == "serve" else chain_readings
        line = json.dumps({"workload": cell.name, "seed": seed, "readings": fn(ctx, drv),
                           "seconds": time.perf_counter() - ctx.t_start})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
