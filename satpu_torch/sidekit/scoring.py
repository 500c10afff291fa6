"""Privacy/utility scoring metrics (reference sidekit/scoring/{__init__,metric}.py).

A copy of ``satpu.sidekit.scoring`` (numpy only).

Pure numpy, host-side evaluation code: cosine scoring, adaptive S-norm,
linkability (Gomez-Barrero Dsys), Cllr / min-Cllr via PAV optimal calibration
with ROCCH-EER, and a bootstrap EER confidence interval (the reference uses
the external ``feerci`` package; we implement the same bootstrap estimator).

Algorithm provenance: ``pavx`` / ``optimal_llr`` / ``rocch`` follow the
published BOSARIS toolkit recipes (Brummer & de Villiers, 2011) and
``linkability`` follows Gomez-Barrero et al., "General framework to evaluate
unlinkability in biometric template protection systems" (IEEE TIFS 2018) —
the same third-party algorithms the reference vendors in
sidekit/scoring/metric.py (credited there to the VoicePrivacy
anonymization_metrics code). Any correct implementation of these numerical
procedures is necessarily near-identical step-for-step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def cosine_scoring(embd1s: np.ndarray, embd2s: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity (scoring/__init__.py:47-55), vectorized."""
    a = np.asarray(embd1s, dtype=np.float64)
    b = np.asarray(embd2s, dtype=np.float64)
    na = np.linalg.norm(a, axis=1)
    nb = np.linalg.norm(b, axis=1)
    return np.sum(a * b, axis=1) / np.maximum(na * nb, 1e-30)


def asnorm(enroll_test_scores, enroll_xv, test_xv, cohort_xv, k: int = 200):
    """Adaptive s-norm with top-k cohort (scoring/__init__.py:7-46)."""
    enroll_xv = np.asarray(enroll_xv)
    test_xv = np.asarray(test_xv)
    cohort_xv = np.asarray(cohort_xv)
    k = min(k, cohort_xv.shape[0])

    def topk_stats(xv):
        scores = xv @ cohort_xv.T
        part = np.partition(scores, -k, axis=1)[:, -k:]
        return part.mean(axis=1), part.std(axis=1, ddof=1)

    mean_e, std_e = topk_stats(enroll_xv)
    mean_t, std_t = topk_stats(test_xv)
    s = np.asarray(enroll_test_scores)
    z = (s - mean_e) / std_e
    t = (s - mean_t) / std_t
    return 0.5 * (z + t)


def linkability(mated, non_mated, omega: float = 1.0, n_bins: int = -1):
    """Global linkability Dsys (metric.py:10-70)."""
    mated = np.asarray(mated, dtype=np.float64)
    non_mated = np.asarray(non_mated, dtype=np.float64)
    if n_bins < 0:
        n_bins = min(int(len(mated) / 10), 100)
    lo = min(mated.min(), non_mated.min())
    hi = max(mated.max(), non_mated.max())
    bin_edges = np.linspace(lo, hi, num=n_bins + 1, endpoint=True)
    bin_centers = (bin_edges[1:] + bin_edges[:-1]) / 2
    y1 = np.histogram(mated, bins=bin_edges, density=True)[0]
    y2 = np.histogram(non_mated, bins=bin_edges, density=True)[0]
    lr = np.divide(y1, y2, out=np.ones_like(y1), where=y2 != 0)
    D = 2 * (omega * lr / (1 + omega * lr)) - 1
    D[omega * lr <= 1] = 0
    D[(y2 == 0) & (y1 != 0)] = 1
    Dsys = np.trapezoid(x=bin_centers, y=D * y1)
    return Dsys, D, bin_centers, bin_edges


def sigmoid(log_odds):
    return 1.0 / (1.0 + np.exp(-np.asarray(log_odds, dtype=np.float64)))


def logit(p):
    p = np.asarray(p, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return np.log(p) - np.log1p(-p)


def pavx(y: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pool Adjacent Violators (metric.py:359-425): nondecreasing ghat
    minimizing ||y - ghat||^2; also returns PAV bin widths and heights."""
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    assert n > 0
    index = np.zeros(n, dtype=int)
    length = np.zeros(n, dtype=int)
    ghat = np.zeros(n)
    ci = 0
    index[0] = 1
    length[0] = 1
    ghat[0] = y[0]
    for j in range(1, n):
        ci += 1
        index[ci] = j + 1
        length[ci] = 1
        ghat[ci] = y[j]
        while ci >= 1 and ghat[ci - 1] >= ghat[ci]:
            nw = length[ci - 1] + length[ci]
            ghat[ci - 1] += (length[ci] / nw) * (ghat[ci] - ghat[ci - 1])
            length[ci - 1] = nw
            ci -= 1
    height = ghat[: ci + 1].copy()
    width = length[: ci + 1].copy()
    m = n
    while m >= 0:
        for j in range(index[ci], m + 1):
            ghat[j - 1] = ghat[ci]
        m = index[ci] - 1
        ci -= 1
    return ghat, width, height


def optimal_llr(tar, non, laplace: bool = False, monotonicity_epsilon: float = 1e-6,
                compute_eer: bool = False):
    """PAV-optimal score calibration + ROCCH-EER (metric.py:428-536)."""
    tar = np.asarray(tar, dtype=np.float64)
    non = np.asarray(non, dtype=np.float64)
    scores = np.concatenate([non, tar])
    Pideal = np.concatenate([np.zeros(len(non)), np.ones(len(tar))])
    perturb = np.argsort(scores, kind="mergesort")
    Pideal = Pideal[perturb]
    if laplace:
        Pideal = np.hstack([1, 0, Pideal, 1, 0])
    Popt, width, _ = pavx(Pideal)
    if laplace:
        Popt = Popt[2 : len(Popt) - 2]
    posterior_log_odds = logit(Popt)
    log_prior_odds = np.log(len(tar) / len(non))
    llrs = posterior_log_odds - log_prior_odds
    N = len(tar) + len(non)
    llrs = llrs + np.arange(N) * monotonicity_epsilon / N
    idx_reverse = np.zeros(len(scores), dtype=int)
    idx_reverse[perturb] = np.arange(len(scores))
    tar_llrs = llrs[idx_reverse][len(non):]
    nontar_llrs = llrs[idx_reverse][: len(non)]
    if not compute_eer:
        return tar_llrs, nontar_llrs

    nbins = width.shape[0]
    pmiss = np.zeros(nbins + 1)
    pfa = np.zeros(nbins + 1)
    left = 0
    fa = non.shape[0]
    miss = 0
    for i in range(nbins):
        pmiss[i] = miss / len(tar)
        pfa[i] = fa / len(non)
        left = int(left + width[i])
        miss = np.sum(Pideal[:left])
        fa = len(tar) + len(non) - left - np.sum(Pideal[left:])
    pmiss[nbins] = miss / len(tar)
    pfa[nbins] = fa / len(non)
    eer = 0.0
    for i in range(pfa.shape[0] - 1):
        xx = pfa[i : i + 2]
        yy = pmiss[i : i + 2]
        XY = np.column_stack((xx, yy))
        dd = np.array([1, -1]) @ XY
        if np.min(np.abs(dd)) == 0:
            eerseg = 0.0
        else:
            seg = np.linalg.solve(XY, np.array([[1], [1]]))
            eerseg = 1.0 / np.sum(seg)
        eer = max(eer, eerseg)
    return tar_llrs, nontar_llrs, eer


def cllr(tar_llrs, nontar_llrs) -> float:
    """Application-independent cost (metric.py:250-292)."""
    log2 = np.log(2)
    tar_post = sigmoid(tar_llrs)
    non_post = sigmoid(-np.asarray(nontar_llrs))
    if np.any(tar_post == 0) or np.any(non_post == 0):
        return np.inf
    c1 = (-np.log(tar_post)).mean() / log2
    c2 = (-np.log(non_post)).mean() / log2
    return (c1 + c2) / 2


def min_cllr(tar_llrs, nontar_llrs, monotonicity_epsilon: float = 1e-6,
             compute_eer: bool = False, return_opt: bool = False):
    """minCllr via PAV calibration (metric.py:295-356)."""
    if compute_eer:
        tar, non, eer = optimal_llr(tar_llrs, nontar_llrs, laplace=False,
                                    monotonicity_epsilon=monotonicity_epsilon,
                                    compute_eer=True)
        cmin = cllr(tar, non)
        return (cmin, eer, tar, non) if return_opt else (cmin, eer)
    tar, non = optimal_llr(tar_llrs, nontar_llrs, laplace=False,
                           monotonicity_epsilon=monotonicity_epsilon)
    cmin = cllr(tar, non)
    return (cmin, tar, non) if return_opt else cmin


def eer_point(tar, non) -> float:
    """Classic EER from score lists (interpolated ROC crossing)."""
    tar = np.sort(np.asarray(tar, dtype=np.float64))
    non = np.sort(np.asarray(non, dtype=np.float64))
    all_scores = np.concatenate([tar, non])
    thresholds = np.unique(all_scores)
    pmiss = np.searchsorted(tar, thresholds, side="left") / len(tar)
    pfa = 1.0 - np.searchsorted(non, thresholds, side="left") / len(non)
    diff = pmiss - pfa
    idx = np.argmax(diff >= 0)
    if idx == 0:
        return float((pmiss[0] + pfa[0]) / 2)
    # linear interpolation between the crossing thresholds
    x0, x1 = diff[idx - 1], diff[idx]
    w = 0.0 if x1 == x0 else -x0 / (x1 - x0)
    eer = (1 - w) * (pmiss[idx - 1] + pfa[idx - 1]) / 2 + w * (pmiss[idx] + pfa[idx]) / 2
    return float(eer)


def eer_ci_bootstrap(tar, non, n_boot: int = 100, alpha: float = 0.05,
                     seed: int = 0) -> Tuple[float, float, float]:
    """Bootstrap EER with (1-alpha) CI — the reference's feerci equivalent.

    Returns (eer, ci_lower, ci_upper).
    """
    rng = np.random.default_rng(seed)
    tar = np.asarray(tar)
    non = np.asarray(non)
    eer = eer_point(tar, non)
    boots = []
    for _ in range(n_boot):
        t = tar[rng.integers(0, len(tar), len(tar))]
        n = non[rng.integers(0, len(non), len(non))]
        boots.append(eer_point(t, n))
    boots = np.sort(boots)
    lo = boots[int(np.floor(alpha / 2 * n_boot))]
    hi = boots[min(int(np.ceil((1 - alpha / 2) * n_boot)), n_boot - 1)]
    return eer, float(lo), float(hi)


def ece(tar, non, plo):
    """Empirical cross-entropy of LLR scores at prior log-odds ``plo``
    (metric.py:758-774); the curve behind the reference's ECE plots."""
    tar = np.atleast_1d(np.asarray(tar, np.float64))
    non = np.atleast_1d(np.asarray(non, np.float64))
    plo = np.atleast_1d(np.asarray(plo, np.float64))
    out = np.zeros(plo.shape)
    for i, p in enumerate(plo):
        out[i] = sigmoid(p) * np.mean(-np.log(sigmoid(tar + p)))
        out[i] += sigmoid(-p) * np.mean(-np.log(sigmoid(-non - p)))
    return out / np.log(2)


def int_ece(x, epsilon: float = 1e-6) -> float:
    """Z(X) of the reference's DECE paper (metric.py:789-806), vectorized:
    Z = 0.25 + mean((a - b) / b^2) / 2 with b = exp(a) - 1 over LLRs a;
    +inf contributes the 0.25 constant, |a| < epsilon contributes Z(0) = 0."""
    x = np.asarray(x, np.float64)
    idx = (~np.isinf(x)) & (np.abs(x) > epsilon)
    contrib = np.zeros(len(x))
    xx = x[idx]
    lrm1 = np.exp(xx) - 1.0
    contrib[idx] = (xx - lrm1) / lrm1 ** 2
    contrib[np.abs(x) < epsilon] = -0.5  # Z(0) = 0 = 0.25 + (-0.5)/2
    return 0.25 + contrib.mean() / 2.0


def dece(tar_llrs, nontar_llrs) -> float:
    """Discrepancy empirical cross-entropy summary (metric.py:809-811)."""
    return (int_ece(np.asarray(tar_llrs))
            + int_ece(-np.asarray(nontar_llrs))) / np.log(2)


def max_abs_llr(tar_llrs, nontar_llrs) -> float:
    """Largest |LLR| in base-10 units (metric.py:851-853)."""
    return float(np.abs(np.hstack((tar_llrs, nontar_llrs))).max() / np.log(10))


def category_tag_evidence(max_llr: float) -> str:
    """ENFSI-inspired strength-of-evidence tag for a base-10 LLR range
    (metric.py:856-877)."""
    eps = np.finfo(float).eps
    ranges = {"0": (0, eps), "A": (eps, 1), "B": (1, 2), "C": (2, 4),
              "D": (4, 5), "E": (5, 6), "F": (6, np.inf)}
    for tag, (lo, hi) in ranges.items():
        if lo <= max_llr < hi:
            return tag
    return "F"


def ece_plot(tar_llrs, nontar_llrs, output_file: str) -> str:
    """The reference's ECE curve figure (metric.py:815-847): ECE of the
    calibrated scores vs the logit prior, against the reference ECE of a
    no-information system, titled with DECE / max|LLR| / evidence category.
    Writes ``<output_file>.png`` (and .pdf) and returns the png path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tar_llrs = np.asarray(tar_llrs, np.float64)
    nontar_llrs = np.asarray(nontar_llrs, np.float64)
    d = dece(tar_llrs, nontar_llrs)
    m = max_abs_llr(tar_llrs, nontar_llrs)
    tag = category_tag_evidence(m)

    plo = np.arange(-7, 7, 0.25)
    min_pe = ece(tar_llrs, nontar_llrs, plo)
    ref_pe = ece(np.array([0.0]), np.array([0.0]), plo)
    plt.clf()
    ax = plt.gca()
    ax.plot(plo, ref_pe, label=r"$\mathrm{ECE}^{ref}$", color="black",
            linewidth=2, linestyle=":")
    ax.plot(plo, min_pe, label=r"$\mathrm{ECE}$", color="#e66101", linewidth=2)
    ax.set_ylabel("ECE (bits)")
    ax.set_xlabel("logit prior")
    ax.set_title(r"$\mathrm{D}_{\mathrm{ECE}}$ = %.2f, $max_{|llr|}$ = %.2f, %s"
                 % (d, m, tag), y=1.02)
    ax.legend(loc="upper right")
    base = output_file
    for ext in (".pdf", ".png", ".csv", ".txt"):
        base = base.replace(ext, "")
    plt.savefig(base + ".pdf", format="pdf")
    plt.savefig(base + ".png", format="png")
    return base + ".png"
