"""Learning-rate schedules and kaldi job math (port of
``satpu.utils.schedules``; reference script_utils.py:22-82 and
lr_scheduler.py), as functions of Python numbers."""
from __future__ import annotations

import math
from typing import Callable


def get_current_num_jobs(it: int, num_iters: int, start: int, step: int, end: int) -> int:
    """Kaldi-style job ramp num_jobs_initial -> num_jobs_final
    (script_utils.py:22-29)."""
    if num_iters <= 1:
        return end
    ideal = float(start) + (end - start) * float(it) / num_iters
    if step <= 1:
        return int(0.5 + ideal)
    return int(0.5 + ideal / step) * step


def get_learning_rate(it: int, num_jobs: int, num_iters: int,
                      num_archives_processed: int, num_archives_to_process: int,
                      initial_effective_lrate: float, final_effective_lrate: float,
                      schedule_type: str = "linear") -> float:
    """Kaldi LR schedules (script_utils.py:32-82): none | linear | exponential.
    The returned rate is scaled by num_jobs (model-averaging semantics)."""
    if schedule_type == "none":
        return initial_effective_lrate
    if schedule_type == "linear":
        epoch_no = (num_archives_processed // num_archives_to_process) + 1
        return (initial_effective_lrate / epoch_no) * num_jobs
    if schedule_type == "exponential":
        if it + 1 >= num_iters:
            eff = final_effective_lrate
        else:
            eff = initial_effective_lrate * math.exp(
                num_archives_processed
                * math.log(final_effective_lrate / initial_effective_lrate)
                / num_archives_to_process)
        return num_jobs * eff
    raise ValueError(schedule_type)


def one_cycle(lr_max: float, total_steps: int, pct_start: float = 0.3,
              div_factor: float = 25.0, final_div_factor: float = 1e4) -> Callable[[int], float]:
    """OneCycleLR with cosine annealing (lr_scheduler.py:8-55): from
    lr_max / div_factor up to lr_max over the first ``pct_start`` of the
    steps, then down to lr_max / div_factor / final_div_factor."""
    lr_start = lr_max / div_factor
    lr_end = lr_start / final_div_factor
    up_steps = max(int(total_steps * pct_start), 1)
    down_steps = max(total_steps - up_steps, 1)

    def schedule(step: int) -> float:
        if step < up_steps:
            return lr_start + (lr_max - lr_start) * (1 - math.cos(math.pi * step / up_steps)) / 2
        down_pct = min(max((step - up_steps) / down_steps, 0.0), 1.0)
        return lr_end + (lr_max - lr_end) * (1 + math.cos(math.pi * down_pct)) / 2

    return schedule


def cosine_warm_restarts_decay_warmup(base_lr: float, first_cycle_steps: int,
                                      cycle_mult: float = 1.0, min_lr: float = 0.0,
                                      warmup_steps: int = 350,
                                      decay: float = 1.0) -> Callable[[int], float]:
    """CosineAnnealingWarmRestartsWithDecayAndLinearWarmup
    (lr_scheduler.py:57-141) as a step -> lr function."""

    def schedule(step: int) -> float:
        t_i = first_cycle_steps
        t_cur = step
        lr_base = base_lr
        while t_cur >= t_i:
            t_cur -= t_i
            t_i = int(t_i * cycle_mult)
            lr_base *= decay
        warm = min((step + 1) / warmup_steps, 1.0)
        return warm * (min_lr + (lr_base - min_lr) * (1 + math.cos(math.pi * t_cur / t_i)) / 2)

    return schedule


def exponential_decay_per_epoch(base_lr: float, gamma: float) -> Callable[[int], float]:
    """torch ExponentialLR (per-epoch decay): epoch -> base_lr * gamma**epoch."""

    def schedule(epoch: int) -> float:
        return base_lr * (gamma ** epoch)

    return schedule
