"""The port's ``train_asv`` CLI against satpu's on the CPU, on a kaldi dir
that the test writes (4 speakers x 3 voiced utterances of 0.9-2.6 s; 0.5 s
chunks), a tiny ECAPA (32 channels, 16-d embedding), B=8:

- 2 epochs from the same initial weights (satpu's init, given to the port
  as ``--init-weight-model``), SpecAugment off on both sides (satpu's masks
  come from jax.random), the port fed satpu's log-mel features (the
  train-mode trunk amplifies the frontends' 4e-5 difference,
  ``test_torch_asv_trainer.py``): the same per-epoch loss (rel 1e-4), the
  same validation EER and the same ``best.ckpt`` epoch; on its own features
  the losses within 2% (0.64% measured);
- a third epoch resumed from ``trainer_1.ckpt`` on both sides, and a
  fine-tune warm start from each side's ``1.ckpt`` (m 0.4, no random shift):
  the same again;
- the checkpoints: model and trainer files, GC, the ``best.ckpt`` symlink,
  the metrics log; ``best.ckpt`` loads through ``infer_helper.load_model``
  and ``eval_anon``'s ``evaluate_asv`` scores trials with it;
- the other options run (ResNet, bf16, augmentation, the exponential
  schedule, SpecAugment on), and ``WORLD_SIZE > 1`` raises naming item 15."""
import json
import os

import numpy as np
import pytest
import torch

from torch_parity import harmonic

ARGS = ["--arch", "ecapa", "--duration", "0.5", "--samples-per-speaker", "2",
        "--examples-per-speaker", "2", "--minibatch-size", "8", "--lr", "0.005",
        "--channels", "32", "--embedding-size", "16", "--seed", "1234"]


def _write_dir(root):
    from satpu_torch.utils import kaldi_data

    d = os.path.join(root, "data")
    os.makedirs(d)
    wav_scp, utt2spk = {}, {}
    for s in range(4):
        for u in range(3):
            x, _ = harmonic(14400 + 4800 * u + 1600 * s, 100.0 + 40 * s + 7 * u, seed=10 * s + u)
            utt = f"spk{s}-u{u}"
            wav_scp[utt] = os.path.join(root, utt + ".wav")
            kaldi_data.write_wav(wav_scp[utt], x, 16000)
            utt2spk[utt] = f"spk{s}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(d, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(d, "utt2spk"))
    return d


def _epochs(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """satpu's and the port's runs: 2 epochs, a resumed third, a fine-tune."""
    import jax

    import satpu.sidekit.xvector as JX
    import satpu_torch.sidekit.xvector as PX
    from satpu.bin import train_asv as J
    from satpu.sidekit.trainer import init_asv_state, make_asv_optimizer
    from satpu.sidekit.xvector import XVectorConfig, build_xvector
    from satpu_torch import infer_helper
    from satpu_torch.bin import train_asv as P
    from satpu_torch.models.convert import from_satpu_xvector
    from torch_parity import jax_variables_numpy

    root = str(tmp_path_factory.mktemp("asv_cli"))
    data = _write_dir(root)
    # satpu's initial weights (its CLI's init: seed 1234, a [2, 8000] example)
    state = init_asv_state(build_xvector(XVectorConfig(num_speakers=4, channels=32,
                                                       embedding_size=16)),
                           jax.random.PRNGKey(1234), np.zeros((2, 8000), np.float32),
                           make_asv_optimizer())
    init = os.path.join(root, "init.ckpt")
    infer_helper.save_model(init, "asv_xvector", {}, from_satpu_xvector(jax_variables_numpy(
        {"params": state.params, "batch_stats": state.batch_stats})))
    exp = {k: os.path.join(root, "exp_" + k) for k in ("satpu", "port", "port_own")}
    ft = {k: v + "_ft" for k, v in exp.items()}

    def run(side, dirname, *extra):
        np.random.seed(1234)  # satpu's dither stream (the port seeds its own)
        if side == "satpu":
            return J.main(["--train-set", data, "--dirname", dirname, *ARGS, *extra])
        return P.main(["--train-set", data, "--dirname", dirname, "--device", "cpu", *ARGS,
                       *extra])

    def satpu_frontend(wav, n_mels):  # satpu's log-mel features, [B, F, T]
        out = np.asarray(J_mel(wav.numpy(), n_mels=n_mels))
        return torch.from_numpy(np.ascontiguousarray(out.transpose(0, 2, 1)))

    from satpu.sidekit.preprocessor import mel_spec_frontend as J_mel

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JX, "spec_masking", lambda x, key: x)
        mp.setattr(PX, "apply_spec_masks", lambda x, masks: x)
        for side in ("satpu", "port", "port_own"):
            if side == "port":
                mp.setattr(PX, "mel_spec_frontend", satpu_frontend)
            elif side == "port_own":
                mp.undo()
                mp.setattr(PX, "apply_spec_masks", lambda x, masks: x)
            first = ("--init-weight-model", init) if side != "satpu" else ()
            assert run(side, exp[side], "--epochs", "2", *first) == 0
            assert run(side, exp[side], "--epochs", "3") == 0  # resumes at epoch 2
            assert run(side, ft[side], "--epochs", "1", "--fine-tune", "true",
                       "--init-weight-model", os.path.join(exp[side], "1.ckpt")) == 0
    torch.set_num_threads(n)
    return {"root": root, "data": data, "exp": exp, "ft": ft}


def _same_epochs(port_dir, satpu_dir, n):
    port, ref = _epochs(port_dir), _epochs(satpu_dir)
    assert [r["epoch"] for r in port] == [r["epoch"] for r in ref] == list(range(n))
    for p, j in zip(port, ref):
        assert np.isfinite(p["loss"]) and abs(p["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"])
        assert p["val_eer"] == pytest.approx(j["val_eer"], abs=1e-12)
        assert p["step"] == j["step"]


def test_two_epochs_and_resume_match_satpu(runs):
    _same_epochs(runs["exp"]["port"], runs["exp"]["satpu"], 3)
    best = {k: os.readlink(os.path.join(v, "best.ckpt")) for k, v in runs["exp"].items()}
    assert best["port"] == best["satpu"]


def test_fine_tune_warm_start_matches_satpu(runs):
    _same_epochs(runs["ft"]["port"], runs["ft"]["satpu"], 1)


def test_own_frontend_runs_follow_satpu(runs):
    """With the port's own frontend the train-mode trunk's ill-conditioning
    moves the losses: within 2% of satpu's."""
    for kind in ("exp", "ft"):
        port, ref = _epochs(runs[kind]["port_own"]), _epochs(runs[kind]["satpu"])
        assert len(port) == len(ref)
        for p, j in zip(port, ref):
            assert abs(p["loss"] - j["loss"]) <= 2e-2 * abs(j["loss"])


def test_checkpoints_load_and_score(runs):
    """Model and trainer checkpoints (the GC keeps 2 trainer files), the
    best.ckpt symlink, an asv_xvector model that eval_anon scores with."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import eval_anon
    from satpu_torch.utils import kaldi_data

    exp = runs["exp"]["port"]
    names = set(os.listdir(exp))
    assert {"0.ckpt", "1.ckpt", "2.ckpt", "trainer_1.ckpt", "trainer_2.ckpt",
            "metrics.jsonl"} <= names and "trainer_0.ckpt" not in names
    best = os.path.join(exp, "best.ckpt")
    assert os.path.islink(best)
    model, meta = infer_helper.load_model(best, device="cpu")
    assert meta["model_id"] == "asv_xvector"
    assert meta["speakers"] == [f"spk{s}" for s in range(4)]
    assert meta["epoch"] == int(os.readlink(best).split(".")[0])
    assert (model.cfg.channels, model.cfg.embedding_size, model.cfg.num_speakers) == (32, 16, 4)
    # evaluation: enrol u0 of each speaker, trials on u1 / u2 against every speaker
    data = runs["data"]
    wav_scp = kaldi_data.read_wav_scp(os.path.join(data, "wav.scp"))
    enroll = os.path.join(runs["root"], "enroll")
    os.makedirs(enroll)
    kaldi_data.write_keyed_text({u: p for u, p in wav_scp.items() if u.endswith("u0")},
                                os.path.join(enroll, "wav.scp"))
    kaldi_data.write_keyed_text({u: u.split("-")[0] for u in wav_scp if u.endswith("u0")},
                                os.path.join(enroll, "utt2spk"))
    trials = os.path.join(runs["root"], "trials")
    with open(trials, "w") as f:
        for u in sorted(wav_scp):
            if not u.endswith("u0"):
                for s in range(4):
                    spk = f"spk{s}"
                    f.write(f"{spk} {u} {'target' if u.startswith(spk) else 'nontarget'}\n")
    opts = eval_anon.EvalOpts()
    opts.load_from_args(["--data", data, "--asv-checkpoint", best, "--enroll-dir", enroll,
                         "--trials", trials, "--results", os.path.join(runs["root"], "res"),
                         "--device", "cpu"])
    os.makedirs(opts.results)
    metrics = eval_anon.evaluate_asv(opts)
    assert 0.0 <= metrics["eer"] <= 100.0 and np.isfinite(metrics["linkability"])
    assert os.path.exists(os.path.join(opts.results, "metric.json"))


def test_other_options_run(runs, tmp_path):
    """ResNet, bf16, augmentation over every key, the exponential schedule,
    SpecAugment on (the masks from the epoch's generator): 1 epoch runs and
    writes a finite loss; an unknown schedule is refused."""
    from augment_fixture import write_aug_dbs
    from satpu_torch.bin import train_asv

    aug = write_aug_dbs(str(tmp_path / "aug"))["inline"]
    exp = str(tmp_path / "exp")
    args = ["--train-set", runs["data"], "--dirname", exp, "--device", "cpu", *ARGS,
            "--epochs", "1", "--arch", "resnet", "--compute-dtype", "bfloat16",
            "--augmentation", aug, "--lr-schedule", "exponential"]
    assert train_asv.main(args) == 0
    (rec,) = _epochs(exp)
    assert np.isfinite(rec["loss"]) and rec["step"] == 2
    with pytest.raises(ValueError, match="lr_schedule"):
        train_asv.main(args[:-2] + ["--lr-schedule", "cosine", "--dirname", exp + "_x"])


def test_world_size_raises(monkeypatch, tmp_path):
    """Under a launcher's world of 2 a minibatch that 2 does not divide is
    refused, as satpu refuses it, before any process group or file."""
    from satpu_torch.bin import train_asv

    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="must be divisible by the device count 2"):
        train_asv.main(["--train-set", str(tmp_path), "--dirname", str(tmp_path / "exp"),
                        "--device", "cpu", "--minibatch-size", "9"])
    assert not (tmp_path / "exp").exists()
    assert not torch.distributed.is_initialized()
