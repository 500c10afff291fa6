"""A run with the timed path broken underneath comes out not correct, and
a sound one correct: the harness's own look for a card is skipped and the
rest of a run is driven at CPU size."""
import pytest
import torch

import tiny
from portbench import trace

SERVE = {"wav_gap_vs_bf16": 4.5, "vq_codes_unused": 46.0}
CHAIN = {"loss1_gap": 1e-5, "grad_median_gap": 1e-4, "change_median_gap": 0.1}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def serve_run(seed=7):
    c = tiny.cell("anon_libri_b32", SERVE)
    return c.job().run(tiny.context(c, seed=seed, seconds=2.0))


def chain_run(seed=7):
    c = tiny.cell("chain_libri100_b16", CHAIN)
    return c.job().run(tiny.context(c, seed=seed, seconds=0.5))


def test_sound_runs_are_correct():
    for out in (serve_run(), chain_run()):
        assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["anon_libri_b32", "chain_libri100_b16"])
def test_traced_run_profiles_and_records_the_program(name):
    """A ``--trace 1`` run on the CPU: correct, its breakdown's idle time
    named by the program's span families, and the recorder's stretch
    reported in ``extra`` (no CUDA events here, so no stream ms to read)."""
    c = tiny.cell(name, SERVE if name.startswith("anon") else CHAIN)
    out = c.job().run(tiny.context(c, seconds=0.5, trace=True))
    assert out["correct"], out["checks"]
    gaps = dict(out["breakdown"]["idle_gaps"])
    family = "yaapt." if name.startswith("anon") else "asrbn."
    assert any(k.startswith(family) for k in gaps), gaps
    launches = out["extra"]["launches"]
    assert launches["steps"] >= 1 and all(isinstance(n, int) and n >= 0
                                          for n in launches.values())


def broken_convert(monkeypatch, how):
    from satpu_torch.models.anonymizer import AnonymizationNet

    convert = AnonymizationNet.convert

    def bad(self, wav, f0, target_ids, generator=None):
        out = convert(self, wav, f0, target_ids, generator)
        if how == "half_batch":  # the second half of the batch left out
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        elif how == "altered":  # one answer altered where it is produced
            out = out.clone()
            out[-1] = out[-1] * 0.5
        elif how == "unchanged":  # the input handed back
            out = torch.nn.functional.pad(wav, (0, 1))
        return out

    monkeypatch.setattr(AnonymizationNet, "convert", bad)


@pytest.mark.parametrize("how", ["half_batch", "altered", "unchanged"])
def test_broken_serving_is_not_correct(monkeypatch, how):
    broken_convert(monkeypatch, how)
    out = serve_run()
    assert not out["correct"], out["checks"]


def broken_extractor(monkeypatch, how):
    from satpu_torch.models.asrbn import TDNNFNet

    from portbench import weights

    features, stage1 = TDNNFNet.features, TDNNFNet._stage1
    if how == "uncalibrated":  # the drawn statistics and codebook: one code for all
        monkeypatch.setattr(weights, "calibrate", lambda *a: {})
    elif how == "features":  # the fbank and CMVN features off by a factor
        monkeypatch.setattr(TDNNFNet, "features",
                            lambda self, wav, lengths=None: features(self, wav, lengths) * 0.5)
    elif how == "tdnnf_layer":  # one TDNN-F layer's output channels out of place
        monkeypatch.setattr(TDNNFNet, "_stage1", lambda self, *a, **k: torch.roll(
            stage1(self, *a, **k), 1, dims=1))


@pytest.mark.parametrize("how", ["uncalibrated", "features", "tdnnf_layer"])
def test_broken_extractor_is_not_correct(monkeypatch, how):
    broken_extractor(monkeypatch, how)
    out = serve_run()
    assert not out["correct"], out["checks"]


def broken_step(monkeypatch, how):
    from satpu_torch.chain.trainer import ChainTrainer

    step = ChainTrainer.step

    def bad(self, wav, graphs, frames, **kw):
        if how == "half_batch":  # the mean taken over the first half alone
            h = wav.shape[0] // 2
            return step(self, wav[:h], {k: v[:h] for k, v in graphs.items()}, frames[:h], **kw)
        return step(self, wav, graphs, frames, **kw)

    monkeypatch.setattr(ChainTrainer, "step", bad)
    if how == "unchanged":  # a step that leaves the parameters as they were
        monkeypatch.setattr(ChainTrainer, "apply_grads", lambda self, lr: None)


@pytest.mark.parametrize("how", ["half_batch", "unchanged"])
def test_broken_training_is_not_correct(monkeypatch, how):
    broken_step(monkeypatch, how)
    out = chain_run()
    assert not out["correct"], out["checks"]
