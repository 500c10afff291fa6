"""The port's ``train_asr`` CLI on the CPU over a tiny chain fixture written
with the port's own graph code (``prep.write_random_chain_corpus``: den
graph, numerator FST ark, noise egs): checkpoints, resume, warm start and
gradient accumulation, the final checkpoint served by ``infer_helper``; the
egs loader and the bucket sampler against satpu's (the same batches in the
same order for the same seed, and equal batch arrays); the options the
slice does not port raise, and so does the default device on a machine
without a card."""
import json
import os

import numpy as np
import pytest
import torch

from satpu_torch.bin import train_asr
from satpu_torch.chain.prep import write_random_chain_corpus

TINY = ["--model", "tdnnf_vq", "--codebook-size", "4", "--hidden-dim", "16",
        "--bottleneck-dim", "8", "--prefinal-bottleneck-dim", "8", "--minibatch-size", "2"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chain"))
    fx = write_random_chain_corpus(root, n_utts=6, seconds=1.0, n_phones=4, succ_per_phone=2,
                                   seed=0, n_valid=2)
    fx["root"] = root
    return fx


def _args(fx, exp, *extra):
    return ["--train-set", fx["data"], "--fst-scp", fx["fst_scp"], "--den-fst", fx["den_fst"],
            "--num-pdfs", str(fx["num_pdfs"]), "--dirname", exp, "--device", "cpu",
            "--checkpoint-interval", "2", "--diagnostics-interval", "1", *TINY, *extra]


def _steps(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f]


def test_cli_trains_resumes_and_serves(fixture):
    from satpu_torch import infer_helper
    from satpu_torch.models.asrbn import bn_num_frames
    from satpu_torch.utils.checkpoint import latest_checkpoint

    exp = os.path.join(fixture["root"], "exp")
    valid = ["--valid-set", fixture["valid"], "--valid-fst-scp", fixture["valid_fst_scp"]]
    assert train_asr.main(_args(fixture, exp, "--num-epochs", "1", *valid)) == 0
    names = set(os.listdir(exp))
    assert {"final.ckpt", "3.ckpt", "trainer_2.ckpt", "trainer_3.ckpt"} <= names
    assert _steps(exp) == [1, 2, 3]  # 6 egs of one length, B=2
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert all(np.isfinite(rec[k]) for k in ("chain_objf", "loss", "valid_objf", "vq_loss"))
    # a second call with more epochs resumes from the last trainer checkpoint
    assert train_asr.main(_args(fixture, exp, "--num-epochs", "2", *valid)) == 0
    assert _steps(exp) == [1, 2, 3, 4, 5, 6]
    assert latest_checkpoint(exp, "trainer_") == os.path.join(exp, "trainer_6.ckpt")
    model, meta = infer_helper.load_model(os.path.join(exp, "final.ckpt"), device="cpu")
    assert meta["model_id"] == "asrbn_tdnnf" and meta["steps"] == 6
    assert (model.cfg.hidden_dim, model.cfg.codebook_size) == (16, 4)
    with torch.no_grad():
        bn = model.extract_bn(torch.zeros(1, 16000))
    assert tuple(bn.shape) == (1, bn_num_frames(16000), 8) and torch.isfinite(bn).all()


def test_cli_warm_start_and_gradient_accumulation(fixture, caplog):
    exp = os.path.join(fixture["root"], "exp_acc")
    first = os.path.join(fixture["root"], "exp_init")
    assert train_asr.main(_args(fixture, first, "--num-epochs", "1",
                                "--natural-gradient", "false")) == 0
    with caplog.at_level("INFO"):
        assert train_asr.main(_args(
            fixture, exp, "--num-epochs", "1", "--grad-acc-steps", "2",
            "--init-weight-model", os.path.join(first, "final.ckpt"))) == 0
    assert any("init_weight_model" in r.getMessage() and "skipped" in r.getMessage()
               for r in caplog.records)
    assert _steps(exp) == [1, 2, 3]


@pytest.mark.parametrize("opt", [("--model", "tdnnf_dp"), ("--model", "tdnnf_wav2vec2_vq"),
                                 ("--compute-dtype", "bfloat16"),
                                 ("--augmentation", '{"pipeline": ["add_noise"]}'),
                                 ("--trans-mdl", "0.trans_mdl")],
                         ids=["dp", "wav2vec2", "bf16", "augmentation", "trans_mdl"])
def test_unported_options_raise(fixture, opt):
    exp = os.path.join(fixture["root"], "exp_unported")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_asr.main(_args(fixture, exp, *opt))


def test_default_device_raises_without_a_card(fixture):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    args = _args(fixture, os.path.join(fixture["root"], "exp_dev"))
    i = args.index("--device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_asr.main(args[:i] + args[i + 2:])


def test_egs_and_bucket_sampler_match_satpu(fixture, tmp_path):
    """Utterances of four lengths: the same batches in the same order over
    three epochs, and the same batch arrays."""
    from satpu.chain.dataset import BucketBatchSampler as JSampler
    from satpu.chain.dataset import EgsDataset as JEgs
    from satpu_torch.chain.dataset import BucketBatchSampler, EgsDataset
    from satpu_torch.utils import kaldi_data

    data = fixture["data"]
    lens = {u: 8000 + 1600 * (i % 4) for i, u in
            enumerate(kaldi_data.read_keyed_text(os.path.join(data, "utt2len")))}
    u2l = str(tmp_path / "utt2len")
    kaldi_data.write_keyed_text({u: str(n) for u, n in lens.items()}, u2l)
    args = (os.path.join(data, "wav.scp"), fixture["fst_scp"], u2l)
    ds, jds = EgsDataset(*args), JEgs(*args)
    assert [e.utt for e in ds.egs] == [e.utt for e in jds.egs]
    assert ds.filter_min_path() == jds.filter_min_path()
    for padding in (False, True):
        s, js = BucketBatchSampler(ds, 2, padding, seed=3), JSampler(jds, 2, padding, seed=3)
        assert len(s) == len(js)
        for epoch in range(3):
            s.set_epoch(epoch)
            js.set_epoch(epoch)
            assert list(s) == list(js)
    batch = list(BucketBatchSampler(ds, 2, seed=3))[0]
    (w, g, f, u), (jw, jg, jf, ju) = ds.load_batch(batch), jds.load_batch(batch)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(f, jf)
    assert u == ju and set(g) == set(jg)
    for k in g:
        np.testing.assert_array_equal(g[k], jg[k], err_msg=k)
