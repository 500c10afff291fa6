"""satpu_torch's ASV evaluation against satpu's on the CPU: x-vector
extraction in both modes (max abs 1e-3, cosine >= 0.9999), ``asv_test``
with and without an AS-norm cohort (the same ranking of the trial scores,
then every metric within 1e-6 abs), and the copied scoring module (the
same outputs as satpu's, bit for bit)."""
import numpy as np
import pytest

from torch_parity import XV_TINY, satpu_xvector


@pytest.fixture(scope="module")
def asv():
    return satpu_xvector(seed=3, **XV_TINY)


@pytest.fixture(scope="module")
def memo_extract():
    """satpu's and the port's ``extract_xvectors``, as ``asv_test`` calls
    them, memoised on the waveforms: the cases below share each side's
    x-vectors instead of recomputing them (satpu recompiles every call)."""
    import satpu.sidekit.trainer as J
    import satpu_torch.sidekit.trainer as P

    mp = pytest.MonkeyPatch()
    for mod in (J, P):
        cache, fn = {}, mod.extract_xvectors

        def memo(*args, _cache=cache, _fn=fn, **kw):
            key = tuple(np.asarray(w).tobytes() for w in args[-1]) + tuple(sorted(kw.items()))
            if key not in _cache:
                _cache[key] = _fn(*args, **kw)
            return _cache[key]

        mp.setattr(mod, "extract_xvectors", memo)
    yield J.extract_xvectors, P.extract_xvectors
    mp.undo()


def _wav(n, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (r.standard_normal(n) * 0.1 + 0.2 * np.sin(2 * np.pi * (100 + 30 * seed) * t)
            ).astype(np.float32)


def _close(out, ref):
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-3, np.abs(out - ref).max()
    cos = (out * ref).sum(1) / np.linalg.norm(out, axis=1) / np.linalg.norm(ref, axis=1)
    assert cos.min() >= 0.9999, cos


@pytest.mark.parametrize("mode", ["full", "chunked"])
def test_extract_xvectors_matches_satpu(asv, mode):
    """chunked with a 1 s window and batches of 4: a wrap-padded short
    utterance, an exact window, a kept tail and a dropped one (7 chunks,
    the last batch partial)."""
    from satpu.sidekit.trainer import extract_xvectors as jextract
    from satpu_torch.sidekit.trainer import extract_xvectors

    jm, v, pm = asv
    wavs = [_wav(n, i) for i, n in enumerate((9000, 16000, 40000, 37000))]
    kw = {} if mode == "full" else {"window": 16000, "batch_size": 4}
    ref = jextract(jm, v, wavs, mode=mode, **kw)
    out = extract_xvectors(pm, wavs, mode=mode, **kw)
    assert out.dtype == ref.dtype
    _close(out, ref)


def _trial_setup():
    enroll = {f"spk{s}": [_wav(12000 + 1000 * i, 10 + 3 * s + i) for i in range(2)]
              for s in range(3)}
    trial_wavs = {f"u{i}": _wav(14000 + 500 * i, 30 + i) for i in range(4)}
    trials = [(f"spk{s}", f"u{i}", s == i % 3) for i in range(4) for s in range(3)]
    return enroll, trials, trial_wavs


@pytest.mark.parametrize("cohort", [False, True])
def test_asv_test_matches_satpu(asv, memo_extract, cohort, tmp_path):
    """the same ranking of the 12 trial scores (4 target), then every metric
    (EER and its CI, ROCCH-EER, linkability, Cllr, min-Cllr; AS-norm EER,
    linkability and min-Cllr with a cohort) within 1e-6 abs."""
    from satpu.sidekit.trainer import asv_test as jtest
    from satpu_torch.sidekit import scoring
    from satpu_torch.sidekit.trainer import asv_test

    jm, v, pm = asv
    jextract, extract_xvectors = memo_extract
    enroll, trials, trial_wavs = _trial_setup()
    cohort_xv = None
    if cohort:
        c = np.random.default_rng(5).standard_normal((30, 16)).astype(np.float32)
        cohort_xv = c / np.linalg.norm(c, axis=1, keepdims=True)

    def scores(extract):
        spk = {s: extract(w).mean(0) for s, w in enroll.items()}
        utt = dict(zip(trial_wavs, extract(list(trial_wavs.values()))))
        return scoring.cosine_scoring(np.stack([spk[s] for s, _, _ in trials]),
                                      np.stack([utt[u] for _, u, _ in trials]))

    s_port = scores(lambda w: extract_xvectors(pm, w, mode="chunked"))
    s_ref = scores(lambda w: jextract(jm, v, w, mode="chunked"))
    np.testing.assert_array_equal(np.argsort(s_port), np.argsort(s_ref))

    out = asv_test(pm, enroll, trials, trial_wavs, cohort_xv=cohort_xv,
                   metric_path=str(tmp_path / "metric.json"))
    ref = jtest(jm, v, enroll, trials, trial_wavs, cohort_xv=cohort_xv)
    assert sorted(out) == sorted(ref)
    assert ("asnorm_eer" in out) == cohort
    for k in ref:
        assert abs(out[k] - ref[k]) <= 1e-6, (k, out[k], ref[k])
    assert (tmp_path / "metric.json").exists()


def test_validation_eer_matches_satpu():
    from satpu.sidekit.trainer import validation_eer as jval
    from satpu_torch.sidekit.trainer import validation_eer

    r = np.random.default_rng(8)
    labels = np.repeat(np.arange(5), 4)
    emb = r.standard_normal((20, 16)) + labels[:, None] * 0.3
    assert validation_eer(emb, labels) == jval(emb, labels)


def _score_sets(seed):
    r = np.random.default_rng(seed)
    return r.standard_normal(300) * 0.6 + 1.0, r.standard_normal(1000) * 0.6 - 1.0


@pytest.mark.parametrize("fn", ["cosine_scoring", "asnorm", "linkability", "pavx",
                                "optimal_llr", "cllr", "min_cllr", "eer_point",
                                "eer_ci_bootstrap", "dece", "int_ece"])
def test_scoring_is_satpus(fn):
    """the copied scoring module gives satpu's outputs exactly."""
    from satpu.sidekit import scoring as J
    from satpu_torch.sidekit import scoring as P

    tar, non = _score_sets(9)
    r = np.random.default_rng(10)
    e1, e2, coh = (r.standard_normal((n, 16)).astype(np.float32) for n in (20, 20, 300))
    args = {"cosine_scoring": (e1, e2),
            "asnorm": (np.sum(e1 * e2, axis=1), e1, e2, coh),
            "pavx": (r.standard_normal(50),),
            "optimal_llr": (tar, non, False, 1e-6, True),
            "min_cllr": (tar, non, 1e-6, True),
            "int_ece": (tar,)}.get(fn, (tar, non))
    out, ref = getattr(P, fn)(*args), getattr(J, fn)(*args)
    out, ref = (o if isinstance(o, tuple) else (o,) for o in (out, ref))
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
