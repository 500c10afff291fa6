"""Append-only JSONL scalar log of a training run (the JSONL part of
``satpu.utils.metrics.MetricsWriter``): one ``{"t", "step", ...}`` line per
``write``, in ``<exp_dir>/metrics.jsonl``, appended across resumes."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsWriter:
    def __init__(self, exp_dir: str, name: str = "metrics.jsonl"):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, name)
        self._fh = open(self.path, "a", buffering=1)

    def write(self, step: int, scalars: Dict[str, Any], **extra: Any) -> None:
        """One line: {"t", "step", **scalars, **extra}, numbers as floats."""
        rec = {"t": round(time.time(), 3), "step": int(step)}
        for k, v in {**scalars, **extra}.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
