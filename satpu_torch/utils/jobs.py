"""Process-level job running with retry and fail-fast fan-in (a copy of
``satpu.utils.jobs``; numpy- and torch-free).

The reference's failure handling (SURVEY.md §5.3): chain training jobs retry
up to MAX_RETRIES=10 (egs/asr/librispeech/local/chain/train.py:33,130-141),
and the anonymize bin terminates all sibling processes when one exits
non-zero (satools/bin/anonymize:99-107). ``anonymize --num-procs`` runs its
shards through ``run_parallel_failfast``.
"""
from __future__ import annotations

import logging
import subprocess
import time
from typing import Callable, List, Optional, Sequence, TypeVar

T = TypeVar("T")

MAX_RETRIES = 10


def run_with_retry(fn: Callable[[], T], max_retries: int = MAX_RETRIES,
                   backoff: float = 1.0, name: str = "job") -> T:
    """Call ``fn`` until it succeeds, up to max_retries (asr train.py:130-141).
    Raises the last exception when the cap is reached."""
    last: Optional[BaseException] = None
    for attempt in range(max_retries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - job isolation boundary
            last = e
            logging.warning("%s failed (attempt %d/%d): %s", name, attempt + 1,
                            max_retries, e)
            if attempt + 1 < max_retries and backoff > 0:
                time.sleep(backoff)
    raise RuntimeError(f"{name} failed after {max_retries} attempts") from last


def run_cmd_with_retry(cmd: Sequence[str], max_retries: int = MAX_RETRIES,
                       **popen_kwargs) -> subprocess.CompletedProcess:
    """Subprocess variant: re-run the command until rc == 0 (capped)."""

    def once():
        proc = subprocess.run(list(cmd), **popen_kwargs)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, cmd)
        return proc

    return run_with_retry(once, max_retries=max_retries, name=" ".join(map(str, cmd))[:80])


def run_parallel_failfast(cmds: List[Sequence[str]], poll: float = 0.5,
                          **popen_kwargs) -> List[int]:
    """Launch all commands; if any exits non-zero, terminate the siblings
    (bin/anonymize:99-107). Returns the list of return codes (the failing
    job's rc is preserved; killed siblings report their signal rc)."""
    procs = [subprocess.Popen(list(c), **popen_kwargs) for c in cmds]
    try:
        while True:
            rcs = [p.poll() for p in procs]
            failed = [rc for rc in rcs if rc not in (None, 0)]
            if failed:
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    p.wait()
                logging.error("a job failed (rc=%s); terminated %d siblings",
                              failed[0], sum(1 for rc in rcs if rc is None))
                return [p.returncode for p in procs]
            if all(rc == 0 for rc in rcs):
                return [0] * len(procs)
            time.sleep(poll)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
