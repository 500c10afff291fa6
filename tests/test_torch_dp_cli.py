"""The training CLIs under ``python -m torch.distributed.run --nproc-per-node 2
... --device cpu`` (two gloo ranks; ``train_asr`` also under four) against
the same CLI in one process on
the same global batches: ``train_asr`` (the fbank TDNN-F, NG on, dropout
0.1: a rank draws its block of the global batch's masks), ``train_asv``
(ECAPA, SpecAugment on) and ``train_vc`` (the GAN; its host-local batches
concatenated are the one-process run's batches). Every tensor of the final
checkpoint within relative L2 1e-3 of the one-process run's (the f32
train-mode forward normalizes by the batch's statistics, summed in another
order over the ranks: up to 5.4e-4 measured, in biases that Adam moves by
rounding noise; the GAN's generator 5e-3 and its discriminators 1e-4; the
zero-gradient tensors within 2 lr a step), the same files, the same steps
and epochs in ``metrics.jsonl`` (one writer: each line once) and their
losses within rel 1e-3. Each launch has
its own time limit, and its processes are killed at it."""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_dp_worker import free_port
from torch_parity import ASRBN_TINY, harmonic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One torch thread, and no tensorboard mirror (its import loads
    TensorFlow here, seconds a process) in either run."""
    monkeypatch.setenv("SATPU_TENSORBOARD", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torchrun(target, args, nproc=2):
    """``python -m torch.distributed.run --nproc-per-node <nproc> <target>
    args`` (a module with ``-m``), killed with its workers at TIMEOUT."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="1", SATPU_TENSORBOARD="0")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "localhost", "--master-port", str(free_port()), *target, *args]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=TIMEOUT)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, out
    return out


def _lines(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def _same_run(exp_dp, exp_one, ckpt_name, loss_keys, adam_noise=(), lr=0.0, tol=1e-3):
    """Each tensor within relative L2 ``tol``; ``adam_noise``: tensors whose
    gradient is zero in exact arithmetic, which Adam moves by rounding
    noise: each entry within 2 lr a step."""
    from satpu_torch.utils.checkpoint import load_checkpoint

    a, b = _lines(exp_dp), _lines(exp_one)
    assert [(x["step"], x.get("epoch")) for x in a] == [(x["step"], x.get("epoch")) for x in b]
    for x, y in zip(a, b):
        for k in loss_keys:
            if k in y:
                assert abs(x[k] - y[k]) <= 1e-3 * abs(y[k]), (k, x, y)
    got = load_checkpoint(os.path.join(exp_dp, ckpt_name))[1]
    want = load_checkpoint(os.path.join(exp_one, ckpt_name))[1]
    assert set(got) == set(want)
    steps = max(x["step"] for x in b)
    for k, w in want.items():
        if k in adam_noise:
            assert (got[k] - w).abs().max() <= 2 * lr * steps, k
        elif w.is_floating_point():
            d = (got[k].double() - w.double()).norm() / max(w.double().norm(), 1e-30)
            assert d <= tol, (k, float(d))
        else:
            assert torch.equal(got[k], w), k


def _train_asr_ranks(tmp_path, nproc):
    from satpu_torch.bin import train_asr
    from satpu_torch.chain.prep import write_random_chain_corpus

    fx = write_random_chain_corpus(str(tmp_path / "c"), n_utts=8, seconds=1.0, n_phones=4,
                                   succ_per_phone=2, seed=0)
    # 8 egs of one length: 2 global batches of 4, each rank a block of 4 / nproc
    args = ["--train-set", fx["data"], "--fst-scp", fx["fst_scp"], "--den-fst", fx["den_fst"],
            "--num-pdfs", str(fx["num_pdfs"]), "--device", "cpu", "--model", "tdnnf",
            "--hidden-dim", "16", "--bottleneck-dim", "8", "--prefinal-bottleneck-dim", "8",
            "--minibatch-size", "4", "--num-epochs", "1", "--checkpoint-interval", "2",
            "--diagnostics-interval", "1"]
    dp, one = str(tmp_path / "dp"), str(tmp_path / "one")
    _torchrun(["-m", "satpu_torch.bin.train_asr"], args + ["--dirname", dp], nproc)
    assert train_asr.main(args + ["--dirname", one]) == 0
    assert sorted(os.listdir(dp)) == sorted(os.listdir(one))
    _same_run(dp, one, "final.ckpt", ("loss", "chain_objf"))


def test_train_asr_two_ranks(tmp_path):
    _train_asr_ranks(tmp_path, 2)


def test_train_asr_four_ranks(tmp_path):
    """A row of each global batch a rank: the batch norms' statistics come
    from the other ranks' rows."""
    _train_asr_ranks(tmp_path, 4)


def test_train_asv_two_ranks(tmp_path):
    from satpu_torch.bin import train_asv
    from satpu_torch.utils import kaldi_data

    d = str(tmp_path / "data")
    os.makedirs(d)
    wav_scp, utt2spk = {}, {}
    for s in range(4):
        for u in range(3):
            x, _ = harmonic(14400 + 4800 * u + 1600 * s, 100.0 + 40 * s + 7 * u, seed=10 * s + u)
            utt = f"spk{s}-u{u}"
            wav_scp[utt] = str(tmp_path / f"{utt}.wav")
            kaldi_data.write_wav(wav_scp[utt], x * (0.2 if s % 2 else 1.0), 16000)
            utt2spk[utt] = f"spk{s}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(d, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(d, "utt2spk"))
    args = ["--train-set", d, "--device", "cpu", "--arch", "ecapa", "--duration", "0.5",
            "--samples-per-speaker", "2", "--examples-per-speaker", "2", "--minibatch-size",
            "8", "--lr", "0.005", "--channels", "32", "--embedding-size", "16", "--epochs", "2"]
    dp, one = str(tmp_path / "dp"), str(tmp_path / "one")
    _torchrun(["-m", "satpu_torch.bin.train_asv"], args + ["--dirname", dp])
    assert train_asv.main(args + ["--dirname", one]) == 0
    assert sorted(os.listdir(dp)) == sorted(os.listdir(one))
    # the attention's last bias is under a softmax over time
    _same_run(dp, one, "1.ckpt", ("loss",), adam_noise={"stat_pooling.linear2.bias"}, lr=0.005)


def _vc_data(root):
    from satpu_torch import infer_helper
    from satpu_torch.utils import kaldi_data

    dirs = {}
    for name, utts in (("train", [(s, i) for s in range(3) for i in range(3)]),
                       ("dev", [(0, 3), (2, 3)])):
        d = os.path.join(root, name)
        os.makedirs(d)
        wav_scp, utt2spk = {}, {}
        for s, i in utts:
            utt = f"s{s}-u{i}"
            x, _ = harmonic(19200, 100.0 + 30 * s + 7 * i, seed=10 * s + i)
            wav_scp[utt] = os.path.join(root, f"{utt}.wav")
            kaldi_data.write_wav(wav_scp[utt], x, 16000)
            utt2spk[utt] = f"s{s}"
        kaldi_data.write_keyed_text(wav_scp, os.path.join(d, "wav.scp"))
        kaldi_data.write_keyed_text(utt2spk, os.path.join(d, "utt2spk"))
        dirs[name] = d
    net = infer_helper.build_model("asrbn_tdnnf", device="cpu", seed=0, **ASRBN_TINY)
    dirs["asrbn"] = os.path.join(root, "asrbn.pt")
    infer_helper.save_model(dirs["asrbn"], "asrbn_tdnnf", dict(ASRBN_TINY), net.state_dict())
    return dirs


def test_train_vc_two_ranks(tmp_path, monkeypatch):
    from satpu_torch.bin import train_vc
    from satpu_torch.hifigan import trainer
    from satpu_torch.hifigan.dataset import HifiGanDataset

    fx = _vc_data(str(tmp_path))
    # whole 1.2 s utterances (no random crop: the crops' stream depends on
    # the order a process reads its items in)
    args = ["--train-set", fx["train"], "--dev-set", fx["dev"], "--asrbn-checkpoint",
            fx["asrbn"], "--bn-dim", str(ASRBN_TINY["bottleneck_dim"]), "--minibatch-size",
            "2", "--segment-size", "19200", "--upsample-rates", "4,4",
            "--upsample-kernel-sizes", "8,8", "--upsample-initial-channel", "32",
            "--fake-epoch", "true", "--device", "cpu", "--checkpoint-interval", "2",
            "--training-epochs", "1"]
    dp, one = str(tmp_path / "dp"), str(tmp_path / "one")
    _torchrun([os.path.join(ROOT, "tests", "torch_vc_small_discriminators.py")],
              args + ["--dirname", dp])
    # every rank validates into a dev-set cache shard of its own (one shard
    # appended by both ranks at once would interleave their records)
    shards = os.listdir(os.path.join(fx["dev"], "feature_cache"))
    assert {s.rsplit(".", 2)[-2] for s in shards if s.endswith(".ark")} == {"w0", "w1"}

    monkeypatch.setattr(trainer, "GanHparams", functools.partial(
        trainer.GanHparams, mpd_periods=(2,), msd_scales=2, disc_channel_scale=1 / 16))
    local = HifiGanDataset.batches

    def global_batches(self, batch_size, shuffle=True, epoch=0, process_index=0,
                       process_count=1):
        """The two ranks' host-local batches, concatenated."""
        if not shuffle:
            return local(self, batch_size, shuffle=False)
        parts = [local(self, batch_size // 2, True, epoch, k, 2) for k in range(2)]
        return ({k: np.concatenate([p[k] for p in ps]) for k in ps[0]} for ps in zip(*parts))

    monkeypatch.setattr(HifiGanDataset, "batches", global_batches)
    monkeypatch.setattr(train_vc, "steps_per_epoch", lambda *a: 4)  # the ranks' fewest
    assert train_vc.main(args + ["--dirname", one]) == 0
    names = sorted(os.listdir(dp))
    assert names == sorted(os.listdir(one)) and "g_4.ckpt" in names
    # steps 2 and 4 (the 4 steps of an epoch of 5 and 4 host-local batches)
    # the generator's f32 gradient is ill-conditioned (test_torch_gan_trainer.py:
    # 1e-4 of a tensor's largest entry), and Adam turns that into up to
    # 1.1e-3 in three weight_v tensors here (4e-7 the median); the
    # discriminators 1.7e-6
    _same_run(dp, one, "g_4.ckpt", ("val_mel_error",), tol=5e-3)
    _same_run(dp, one, "d_4.ckpt", (), tol=1e-4)


def test_train_asr_refuses_an_indivisible_minibatch(tmp_path, monkeypatch):
    """Under a launcher's world of 2, satpu's refusal of a minibatch that 2
    does not divide, before any process group or file."""
    from satpu_torch.bin import train_asr

    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="must be divisible by the device count 2"):
        train_asr.main(["--dirname", str(tmp_path / "exp"), "--device", "cpu",
                        "--minibatch-size", "3"])
    assert not (tmp_path / "exp").exists() and not torch.distributed.is_initialized()
