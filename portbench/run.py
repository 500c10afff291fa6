"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's configuration names the job
(``jobs/<job>.py``) that sets the cell up from the seed, drives the
port (``satpu_torch``) for ``--seconds`` and checks what the timed path
produced against the plain reference. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, each read by
``metrics/<metric>.py``. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error. A run exits non-zero and prints no result without a CUDA
card (or with fewer than the cell asks for), without the port, or when a
JAX module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (ROOT,) if p not in sys.path]

from portbench import harness  # noqa: E402

# the build and kernel caches of the program stay inside the checkout, at
# fixed paths, so that a checkout's second run finds what its first built
# (the port's nvcc libraries live in build/satpu_torch/ by their own rule)
CACHES = {"TRITON_CACHE_DIR": os.path.join(ROOT, "build", "portbench", "triton"),
          "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "portbench", "torch_extensions")}


class Context:
    """What a job gets: the cell, the run's arguments, torch and the
    device, and the clock reading at process start."""

    def __init__(self, cell, args, torch, device):
        self.cell, self.torch, self.device = cell, torch, device
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.t_start = T_START


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = harness.Cell(harness.benchmark(), args.workload)
        os.environ.update(CACHES)
        import torch

        # one process a card, with few threads: the steps are bound by one
        # host thread's launches, and idle pool threads only contend with it
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise harness.Refused(f"the cell needs {cell.chips} CUDA card(s); found "
                                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        try:
            import satpu_torch  # noqa: F401  the program under test
        except ImportError as e:
            raise harness.Refused(f"the port (satpu_torch) is not in this checkout: {e}")
        out = cell.job().run(Context(cell, args, torch, torch.device("cuda", 0)))
        bad = harness.forbidden_modules()
        if bad:
            raise harness.Refused(f"modules of JAX or the JAX package were loaded: {bad}")
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except Exception:  # a run that breaks reports why and prints no result
        traceback.print_exc()
        return 1
    for line in harness.checks_text(out["checks"]):
        print(line, file=sys.stderr)
    print(harness.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"],
                              out["device"], out["checks"], out.get("breakdown"),
                              out.get("extra")))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
