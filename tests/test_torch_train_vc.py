"""The port's ``train_vc`` CLI on the CPU over a tiny synthetic dir (3
speakers x 3 voiced utterances of 1.2 s, a tiny frozen extractor
checkpoint, a 4 x 4 upsampling generator, the discriminators shrunk through
the hparams): two epochs leave the checkpoint triplet, ``g_best.ckpt`` and
``metrics.jsonl``; a rerun resumes at the saved step; ``f0_norm = speaker``
stores the speaker statistics and the ``anonymize`` CLI serves that
generator on normalized F0; TF32 is off while it trains; ``checkpoint_gc``
against satpu's."""
import functools
import json
import logging
import os

import numpy as np
import pytest
import torch

from torch_parity import ASRBN_TINY, harmonic

SPEAKERS = ["s0", "s1", "s2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the tier-1 run shares the host's cores among its
    workers, and oversubscribed CPU convs slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vc_data(tmp_path_factory):
    from satpu_torch import infer_helper
    from satpu_torch.utils import kaldi_data

    root = tmp_path_factory.mktemp("vc")
    dirs = {}
    for name, utts in (("train", [(s, i) for s in range(3) for i in range(3)]),
                       ("dev", [(0, 3), (2, 3)])):
        d = str(root / name)
        os.makedirs(d)
        wav_scp, utt2spk = {}, {}
        for s, i in utts:
            utt = f"s{s}-u{i}"
            x, _ = harmonic(19200, 100.0 + 30 * s + 7 * i, seed=10 * s + i)
            p = str(root / f"{utt}.wav")
            kaldi_data.write_wav(p, x, 16000)
            wav_scp[utt], utt2spk[utt] = p, f"s{s}"
        kaldi_data.write_keyed_text(wav_scp, os.path.join(d, "wav.scp"))
        kaldi_data.write_keyed_text(utt2spk, os.path.join(d, "utt2spk"))
        dirs[name] = d
    net = infer_helper.build_model("asrbn_tdnnf", device="cpu", seed=0, **ASRBN_TINY)
    dirs["asrbn"] = str(root / "asrbn.pt")
    infer_helper.save_model(dirs["asrbn"], "asrbn_tdnnf", dict(ASRBN_TINY), net.state_dict())
    dirs["root"] = root
    return dirs


@pytest.fixture
def small_discriminators(monkeypatch):
    from satpu_torch.hifigan import trainer

    monkeypatch.setattr(trainer, "GanHparams", functools.partial(
        trainer.GanHparams, mpd_periods=(2,), msd_scales=2, disc_channel_scale=1 / 16))


def _args(vc_data, exp, *extra):
    return ["--train-set", vc_data["train"], "--dev-set", vc_data["dev"], "--dirname", exp,
            "--asrbn-checkpoint", vc_data["asrbn"], "--bn-dim", str(ASRBN_TINY["bottleneck_dim"]),
            "--minibatch-size", "2", "--segment-size", "16320", "--upsample-rates", "4,4",
            "--upsample-kernel-sizes", "8,8", "--upsample-initial-channel", "32",
            "--fake-epoch", "true", "--device", "cpu", *extra]


def _lines(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def test_two_epochs_then_resume(vc_data, small_discriminators, caplog):
    from satpu_torch import infer_helper
    from satpu_torch.bin import train_vc

    exp = str(vc_data["root"] / "exp")
    assert train_vc.main(_args(vc_data, exp, "--training-epochs", "2")) == 0
    # 9 utterances at B=2: 5 steps an epoch (the tail wraps around)
    names = set(os.listdir(exp))
    assert {"g_10.ckpt", "d_10.ckpt", "trainer_10.ckpt", "g_5.ckpt"} <= names
    assert os.path.islink(os.path.join(exp, "g_best.ckpt"))
    assert os.readlink(os.path.join(exp, "g_best.ckpt")) in ("g_5.ckpt", "g_10.ckpt")
    val = [r for r in _lines(exp) if "val_mel_error" in r]
    assert [r["step"] for r in val] == [5, 10] and all(np.isfinite(r["val_mel_error"])
                                                        for r in val)
    # the features were computed once, into the data dirs' caches
    assert any(f.startswith("get_f0") for f in os.listdir(
        os.path.join(vc_data["train"], "feature_cache")))

    model, meta = infer_helper.load_model(os.path.join(exp, "g_10.ckpt"), device="cpu")
    assert meta["model_id"] == "anonymizer_tdnnf_hifigan" and meta["speakers"] == SPEAKERS
    assert (meta["epoch"], meta["steps"]) == (2, 10)
    assert model.cfg.upsample_rates == (4, 4) and model.cfg.num_speakers == 3
    assert model.cfg.f0_norm == "utt" and "f0_speaker_stats" not in meta
    # the frozen extractor rides along unchanged
    frozen = infer_helper.load_model(vc_data["asrbn"], device="cpu")[0].state_dict()
    assert all(torch.equal(model.state_dict()[f"bn_extractor.{k}"], v)
               for k, v in frozen.items())

    # a rerun with a third epoch resumes at step 10
    with caplog.at_level(logging.INFO):
        assert train_vc.main(_args(vc_data, exp, "--training-epochs", "3")) == 0
    assert "epoch 2, step 10" in caplog.text
    assert "trainer_15.ckpt" in os.listdir(exp)
    assert [r["step"] for r in _lines(exp) if "val_mel_error" in r] == [5, 10, 15]


def test_speaker_f0_norm_trains_and_serves(vc_data, small_discriminators):
    """f0_norm = speaker stores the statistics; anonymize's wavs equal a
    direct convert on the speaker-normalized F0 within one PCM16 step."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import anonymize, train_vc
    from satpu_torch.ops.cmvn import SpeakerCMVN
    from satpu_torch.utils import kaldi_data

    exp = str(vc_data["root"] / "exp_spk")
    assert train_vc.main(_args(vc_data, exp, "--training-epochs", "1",
                               "--f0-norm", "speaker")) == 0
    g = os.path.join(exp, "g_5.ckpt")
    model, meta = infer_helper.load_model(
        g, device="cpu", option_args=infer_helper.serving_option_args("float32"))
    assert model.cfg.f0_norm == "none"
    stats = meta["f0_speaker_stats"]
    assert sorted(stats["stats"]) == SPEAKERS and stats["keep_zeros"]

    out = str(vc_data["root"] / "anon_spk")
    assert anonymize.main(["--checkpoint", g, "--directory", vc_data["dev"], "--device", "cpu",
                           "--compute-dtype", "float32", "--batch-size", "4",
                           "--target-selection-algorithm", "constant",
                           "--target-constant-spkid", "s1", "--results-dir", out,
                           "--new-datadir-suffix", "_anon_spk"]) == 0
    scp = kaldi_data.read_wav_scp(os.path.join(vc_data["dev"] + "_anon_spk", "wav.scp"))
    src = kaldi_data.read_wav_scp(os.path.join(vc_data["dev"], "wav.scp"))
    utt2spk = kaldi_data.read_keyed_text(os.path.join(vc_data["dev"], "utt2spk"))
    utts = sorted(src)
    wavs = {u: kaldi_data.load_wav_from_scp(src[u])[0][0] for u in utts}
    batch = np.zeros((4, 32000), np.float32)
    for j, u in enumerate(utts):
        batch[j, :len(wavs[u])] = wavs[u]
    cmvn = SpeakerCMVN.from_meta(stats)
    with torch.no_grad():
        w = torch.from_numpy(batch)
        f0 = model.get_f0(w).numpy()
        for j, u in enumerate(utts):
            f0[j] = cmvn(f0[j], utt2spk[u])
        direct = model.convert(w, torch.from_numpy(f0), torch.full((4,), 1)).numpy()
    for j, u in enumerate(utts):
        got, _ = kaldi_data.load_wav_from_scp(scp[u])
        # the 4 x 4 generator writes 16 samples a BN frame, not 320
        want = np.clip(direct[j, :len(wavs[u])], -1.0, 1.0)
        assert got.shape == (1, len(want)) and np.abs(want).max() > 0
        assert np.abs(got[0] - want).max() <= 1.5 / 32768


def test_init_weight_model_warm_starts_the_generator(vc_data, small_discriminators, caplog):
    """The generator's tensors of a g_ checkpoint, not its extractor."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import train_vc
    from satpu_torch.utils.checkpoint import load_checkpoint

    build = dict(asrbn=dict(ASRBN_TINY), num_speakers=3, bn_dim=ASRBN_TINY["bottleneck_dim"],
                 upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 upsample_initial_channel=32)
    src = str(vc_data["root"] / "warm.ckpt")
    infer_helper.save_model(src, "anonymizer_tdnnf_hifigan", build, infer_helper.build_model(
        "anonymizer_tdnnf_hifigan", device="cpu", seed=7, **build).state_dict())
    exp = str(vc_data["root"] / "exp_warm")
    with caplog.at_level(logging.INFO):
        assert train_vc.main(_args(vc_data, exp, "--training-epochs", "1",
                                   "--init-weight-model", src, "--lr", "0.0")) == 0
    n = sum(k.startswith("hifigan.") for k in load_checkpoint(src)[1])
    assert f"{n} generator tensors transferred, 0 skipped" in caplog.text
    # lr 0: the weight decay leaves them too (0 x 0.01)
    a, b = load_checkpoint(src)[1], load_checkpoint(os.path.join(exp, "g_5.ckpt"))[1]
    assert all(torch.equal(a[k], b[k]) for k in a if k.startswith("hifigan."))


def test_tf32_is_off_while_training_and_restored(vc_data, small_discriminators, monkeypatch):
    """f32 is f32 on the card: both TF32 flags are off in every train and
    validation step, and are as they were once the CLI returns."""
    from satpu_torch.bin import train_vc
    from satpu_torch.hifigan.trainer import GanTrainer

    seen = []
    for name in ("train_step", "eval_step"):
        def flagged(self, batch, _step=getattr(GanTrainer, name)):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return _step(self, batch)

        monkeypatch.setattr(GanTrainer, name, flagged)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    exp = str(vc_data["root"] / "exp_tf32")
    assert train_vc.main(_args(vc_data, exp, "--training-epochs", "1")) == 0
    # 5 train steps and 1 validation batch
    assert seen == [(False, False)] * 6
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("flag", ["true", "false"])
def test_deterministic_convs_while_training_and_restored(flag, monkeypatch):
    """``--deterministic`` (on by default) puts cuDNN on its deterministic
    conv algorithms without autotuning for the whole run; ``false`` leaves
    the flags as they were; either way they are as they were on return."""
    from satpu_torch.bin import train_vc

    seen = []
    monkeypatch.setattr(train_vc, "_train", lambda opts: seen.append(
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)) or 0)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    args = ["--device", "cpu"] + (["--deterministic", flag] if flag == "false" else [])
    assert train_vc.main(args) == 0
    assert seen == [(True, False) if flag == "true" else (False, True)]
    assert not torch.backends.cudnn.deterministic and torch.backends.cudnn.benchmark


def test_multi_process_is_refused(vc_data, monkeypatch):
    """Under a launcher's world of 2 a minibatch that 2 does not divide is
    refused, as satpu refuses it, before any process group or file; the
    steps an epoch are the fewest any rank's host-local batches give."""
    from satpu_torch.bin import train_vc
    from satpu_torch.hifigan.dataset import HifiGanDataset

    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    exp = vc_data["root"] / "exp_ddp"
    with pytest.raises(ValueError, match="must be divisible by the device count 2"):
        train_vc.main(_args(vc_data, str(exp))[:-2] + ["--minibatch-size", "3"])
    assert not exp.exists() and not torch.distributed.is_initialized()
    class Items:  # a set of n items, for the batch count
        speakers = ["s"]

        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def __getitem__(self, j):
            return np.zeros(2), np.zeros((1, 2)), np.zeros(2), 0

    for n_items in (9, 8, 3, 1):
        for world, bs in ((1, 2), (2, 1), (2, 2), (3, 1)):
            want = min(len(list(HifiGanDataset.batches(Items(n_items), bs, process_index=k,
                                                       process_count=world)))
                       for k in range(world))
            assert train_vc.steps_per_epoch(n_items, bs, world) == want, (n_items, world, bs)


def test_checkpoint_gc_matches_satpu(tmp_path):
    """keep_last, keep_every and a protected symlink target, on the same
    file set for both."""
    from satpu.utils.checkpoint import checkpoint_gc as jgc
    from satpu_torch.utils.checkpoint import checkpoint_gc

    left = {}
    for name, gc in (("port", checkpoint_gc), ("satpu", jgc)):
        d = tmp_path / name
        d.mkdir()
        for step in range(100, 2600, 100):
            for prefix in ("g_", "d_"):
                (d / f"{prefix}{step}.ckpt").write_bytes(b"x")
        os.symlink("g_300.ckpt", d / "g_best.ckpt")
        for prefix in ("g_", "d_"):
            gc(str(d), prefix, keep_last=4, keep_every=1000,
               protected=(str(d / "g_best.ckpt"),))
        left[name] = sorted(os.listdir(d))
    assert left["port"] == left["satpu"]
    assert "g_300.ckpt" in left["port"] and "d_300.ckpt" not in left["port"]
    assert {"g_1000.ckpt", "g_2000.ckpt", "g_2500.ckpt", "g_2200.ckpt"} <= set(left["port"])
    assert "g_2100.ckpt" not in left["port"]
