"""WER / edit-distance scoring (reference satools/satools/jupiter.py:45-226).

A copy of ``satpu.utils.wer`` (numpy only).

``compute_wer`` returns the rate plus the aligned operations so callers can
render diffs or CTM-style reports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class WerResult:
    wer: float
    errors: int
    words: int
    substitutions: int
    insertions: int
    deletions: int
    alignment: List[Tuple[str, str, str]]  # (op, ref_word, hyp_word)

    def __repr__(self):
        return (f"WER {self.wer * 100:.2f}% [{self.errors}/{self.words}] "
                f"sub {self.substitutions} ins {self.insertions} del {self.deletions}")


def compute_wer(ref, hyp) -> WerResult:
    """Levenshtein alignment between token sequences (str or list)."""
    if isinstance(ref, str):
        ref = ref.split()
    if isinstance(hyp, str):
        hyp = hyp.split()
    n, m = len(ref), len(hyp)
    d = np.zeros((n + 1, m + 1), dtype=np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
    # backtrace
    i, j = n, m
    align: List[Tuple[str, str, str]] = []
    subs = ins = dels = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] == hyp[j - 1]:
                align.append(("ok", ref[i - 1], hyp[j - 1]))
            else:
                align.append(("sub", ref[i - 1], hyp[j - 1]))
                subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            align.append(("del", ref[i - 1], ""))
            dels += 1
            i -= 1
        else:
            align.append(("ins", "", hyp[j - 1]))
            ins += 1
            j -= 1
    align.reverse()
    errors = subs + ins + dels
    return WerResult(wer=errors / max(n, 1), errors=errors, words=n,
                     substitutions=subs, insertions=ins, deletions=dels,
                     alignment=align)


def corpus_wer(refs: Dict[str, str], hyps: Dict[str, str]) -> WerResult:
    """Aggregate WER over utterance dicts (kaldi score.sh style)."""
    errs = words = subs = ins = dels = 0
    align: List[Tuple[str, str, str]] = []
    for utt, ref in refs.items():
        r = compute_wer(ref, hyps.get(utt, ""))
        errs += r.errors
        words += r.words
        subs += r.substitutions
        ins += r.insertions
        dels += r.deletions
        align.extend(r.alignment)
    return WerResult(wer=errs / max(words, 1), errors=errs, words=words,
                     substitutions=subs, insertions=ins, deletions=dels,
                     alignment=align)


_OP_STYLE = {
    "ok": "",
    "sub": "background-color:#ffd54f",    # amber: substitution
    "ins": "background-color:#ef9a9a",    # red: insertion
    "del": "background-color:#90caf9;text-decoration:line-through",  # blue: deletion
}


def html_diff(result: WerResult, title: str = "") -> str:
    """Render an alignment as the reference's notebook HTML diff
    (jupiter.py:45-226): hypothesis row with colored sub/ins/del spans and
    the reference word shown as a tooltip on substitutions."""
    parts = ["<div style='font-family:monospace'>"]
    if title:
        parts.append(f"<b>{title}</b> {result!r}<br/>")
    for op, ref_w, hyp_w in result.alignment:
        word = hyp_w if op != "del" else ref_w
        style = _OP_STYLE[op]
        tip = f" title='ref: {ref_w}'" if op == "sub" else ""
        parts.append(f"<span style='{style}'{tip}>{word}</span>" if style
                     else f"<span>{word}</span>")
    parts.append("</div>")
    return " ".join(parts)
