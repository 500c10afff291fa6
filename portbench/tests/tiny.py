"""Tiny cells for the CPU tests: the benchmark's own configurations and
mixes cut down by each cell's job (``tiny(cfg, mix)``), driven on the CPU."""
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


def bench(root: str = ROOT):
    return harness.benchmark(root)


def cell(name: str, limits=None, root: str = ROOT) -> harness.Cell:
    """The cell ``name`` of the BENCHMARK.json at ``root`` with its
    configuration and traffic cut to CPU size by its own job's ``tiny``
    (``jobs/<job>.py``), and ``limits`` for its checks."""
    c = harness.Cell(bench(root), name, root)
    cfg, mix = c.job().tiny(copy.deepcopy(c.config), copy.deepcopy(c.traffic))
    cfg["limits"] = dict(limits or cfg.get("limits", {}))
    c.config, c.traffic = cfg, mix
    return c


def context(c, seed: int = 7, seconds: float = 0.5, trace: bool = False):
    import torch

    return SimpleNamespace(cell=c, torch=torch, device=torch.device("cpu"), seed=seed,
                           seconds=seconds, trace=trace, t_start=time.perf_counter())
