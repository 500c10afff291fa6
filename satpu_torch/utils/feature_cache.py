"""Cached feature extraction: a copy of ``satpu.utils.feature_cache`` (numpy).

``FeatureCache`` memoizes per-utterance feature arrays into appendable
ark/scp shards keyed by (cache_dir, function name, worker name): features
are computed once, the first time an utterance is seen, and read from the
scp cache afterwards. A ``signature`` (the extractor's checkpoint and
config) hashes into the shard names, so a cache written by one extractor is
never read for another.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import Callable, Optional

import numpy as np

from . import scp_io


class FeatureCache:
    def __init__(self, cache_dir: str, func_name: str, worker_name: str = "w0",
                 enabled: bool = True, signature: str = ""):
        self.enabled = enabled
        self.cache_dir = cache_dir
        self.func_name = func_name
        self.worker_name = worker_name
        self._writer: Optional[scp_io.FileWriter] = None
        self._reader: Optional[scp_io.FileReader] = None
        self._lock = threading.Lock()
        if enabled:
            os.makedirs(cache_dir, exist_ok=True)
            sig = ("." + hashlib.sha1(signature.encode()).hexdigest()[:8]
                   if signature else "")
            self._scp = os.path.join(cache_dir, f"{func_name}{sig}.{worker_name}.scp")
            self._ark = os.path.join(cache_dir, f"{func_name}{sig}.{worker_name}.ark")
            if os.path.exists(self._scp):
                self._reader = scp_io.FileReader(self._scp)

    def get(self, utt: str) -> Optional[np.ndarray]:
        if not self.enabled or self._reader is None:
            return None
        if utt in self._reader:
            return self._reader[utt]
        return None

    def put(self, utt: str, value: np.ndarray) -> None:
        if not self.enabled:
            return
        with self._lock:
            if self._writer is None:
                self._writer = scp_io.FileWriter(self._ark, self._scp, append=True)
            self._writer.write(utt, np.asarray(value))
            self._writer.flush()
            # re-read the index: it holds the new record's exact offset
            self._reader = scp_io.FileReader(self._scp)

    def get_or_compute(self, utt: str, compute: Callable[[], np.ndarray]) -> np.ndarray:
        hit = self.get(utt)
        if hit is not None:
            return hit
        value = np.asarray(compute())
        self.put(utt, value)
        return value

    @staticmethod
    def merge_shards(cache_dir: str, func_name: str, out_name: str = "merged") -> str:
        """Concatenate the per-worker scp shards into one."""
        shards = [os.path.join(cache_dir, f) for f in sorted(os.listdir(cache_dir))
                  if f.startswith(func_name + ".") and f.endswith(".scp")]
        out = os.path.join(cache_dir, f"{func_name}.{out_name}.scp")
        scp_io.merge_scps([s for s in shards if not s.endswith(f"{out_name}.scp")], out)
        return out
