"""Tiny cells for the CPU tests: the benchmark's own configurations and
mixes with every width and count cut down, driven on the CPU."""
from __future__ import annotations

import copy
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

ASRBN = {"output_dim": 16, "hidden_dim": 32, "bottleneck_dim": 16,
         "prefinal_bottleneck_dim": 16}
GENERATOR = {"upsample_initial_channel": 32}


def bench():
    return harness.benchmark(ROOT)


def cell(name: str, limits=None) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json with its model and traffic cut to
    CPU size (widths, the den graph, the corpus) and ``limits`` for its
    checks."""
    c = harness.Cell(bench(), name, ROOT)
    cfg, mix = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    if cfg["job"] == "serve":
        cfg["build"]["asrbn"].update(ASRBN)
        cfg["build"].update(num_speakers=3, bn_dim=16, **GENERATOR)
        cfg["generator"].update(GENERATOR)
        mix.update(utterances=6, batch=2, targets=3, check_utterances=3)
        mix["lengths"].update(mean_s=1.0, min_s=0.6, max_s=1.8)
    else:
        cfg["build"].update(ASRBN, output_dim=40, codebook_size=8)
        cfg["den_graph"] = {"phones": 5, "successors": 3, "seed": 2}
        cfg["traced_steps"] = 1
        mix.update(utterances=8, batch=2, allowed_lengths=2)
        mix["lengths"].update(mean_s=1.2, min_s=0.8, max_s=1.6)
    cfg["limits"] = {k: v for k, v in (limits or cfg["limits"]).items()}
    c.config, c.traffic = cfg, mix
    return c


def context(c, seed: int = 7, seconds: float = 0.5, trace: bool = False):
    import torch

    return SimpleNamespace(cell=c, torch=torch, device=torch.device("cpu"), seed=seed,
                           seconds=seconds, trace=trace, t_start=time.perf_counter())
