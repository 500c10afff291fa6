"""The port's ``train_asr`` CLI on the CPU over a tiny chain fixture written
with the port's own graph code (``prep.write_random_chain_corpus``: den
graph, numerator FST ark, noise egs, and a utt2spk over 3 speakers):
checkpoints, resume, warm start and gradient accumulation, waveform
augmentation, the final checkpoint served by ``infer_helper``; the egs
loader and the bucket sampler against satpu's (the same batches in the
same order for the same seed, and equal batch arrays, augmented or not);
every model variant and option a few steps each (``tdnnf_dp``,
``tdnnf_spkadv`` with ``adversarial`` and ``freeze_encoder``,
``tdnnf_wav2vec2{,_vq,_dp}`` large and base with their wav2vec2 front
shrunk for the CPU, ``compute_dtype = bfloat16``, transition-id graphs
through ``trans_mdl``), their checkpoints loaded by ``infer_helper``; the
default device raises on a machine without a card."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from satpu_torch.bin import train_asr
from satpu_torch.chain.prep import write_random_chain_corpus
from satpu_torch.utils import kaldi_data

TINY = ["--model", "tdnnf_vq", "--codebook-size", "4", "--hidden-dim", "16",
        "--bottleneck-dim", "8", "--prefinal-bottleneck-dim", "8", "--minibatch-size", "2"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chain"))
    fx = write_random_chain_corpus(root, n_utts=6, seconds=1.0, n_phones=4, succ_per_phone=2,
                                   seed=0, n_valid=2)
    fx["root"] = root
    utts = sorted(kaldi_data.read_keyed_text(os.path.join(fx["data"], "utt2len")))
    kaldi_data.write_keyed_text({u: f"spk{i % 3}" for i, u in enumerate(utts)},
                                os.path.join(fx["data"], "utt2spk"))
    return fx


# the wav2vec2 fronts the CLI builds, shrunk for the CPU (total stride 320,
# as the real ones): large-style and base-style
W2V_TINY = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8),
                hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
                num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2)


@pytest.fixture
def tiny_wav2vec2(monkeypatch):
    from satpu_torch.models.wav2vec2 import Wav2Vec2Config

    monkeypatch.setattr(Wav2Vec2Config, "large", classmethod(lambda cls: cls(**W2V_TINY)))
    monkeypatch.setattr(Wav2Vec2Config, "base", classmethod(lambda cls: cls(
        **W2V_TINY, do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False)))


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


def _metrics(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _served(exp, model_id):
    """final.ckpt loaded by infer_helper: (model, meta), its bottleneck on
    1 s of audio finite."""
    from satpu_torch import infer_helper

    model, meta = infer_helper.load_model(os.path.join(exp, "final.ckpt"), device="cpu")
    assert meta["model_id"] == model_id and meta["steps"] == 3
    with torch.no_grad():
        bn = model.eval().extract_bn(torch.zeros(1, 16000),
                                     generator=torch.Generator().manual_seed(0))
    assert bn.shape[-1] == 8 and torch.isfinite(bn).all()
    return model, meta


def _transition_id_graphs(fx, root):
    """The fixture's numerators relabelled to transition ids of a
    ``0.trans_mdl`` that the test writes through ``chain.hmm``: (trans_mdl,
    fst scp)."""
    from satpu_torch.chain.dataset import EgsInfo
    from satpu_torch.chain.hmm import TransitionModel, chain_topology
    from satpu_torch.chain.prep import write_fst_ark

    P = fx["num_pdfs"]
    tm = TransitionModel(chain_topology([1]), [(1, 0, 2 * k, 2 * k + 1) for k in range(P // 2)])
    path = os.path.join(root, "0.trans_mdl")
    with open(path, "wb") as f:
        tm.write(f)
    tid_of = {}
    for tid, pdf in tm.pdf_map().items():
        tid_of.setdefault(pdf, tid)
    fsts = {}
    for utt, rx in kaldi_data.read_wav_scp(fx["fst_scp"]).items():
        g = EgsInfo(utt, "", rx, 0).load_fst()
        for arcs in g.arcs:
            for a in arcs:
                if a.ilabel > 0:
                    a.ilabel = a.olabel = tid_of[a.ilabel - 1]
        fsts[utt] = g
    scp = os.path.join(root, "tid_fst.scp")
    write_fst_ark(fsts, os.path.join(root, "tid_fsts.ark"), scp)
    return path, scp


@pytest.mark.parametrize("opt", [("--model", "tdnnf_dp", "--dp-epsilon", "1.0"),
                                 ("--model", "tdnnf_wav2vec2_vq"),
                                 ("--compute-dtype", "bfloat16"),
                                 ("--trans-mdl", "0.trans_mdl")],
                         ids=["dp", "wav2vec2", "bf16", "trans_mdl"])
def test_unported_options_raise(fixture, opt, tiny_wav2vec2):
    """The options this test once held to NotImplementedError now train: 3
    steps each, finite metrics, final.ckpt served. ``trans_mdl`` trains on
    numerators over transition ids and logs the same metrics as the run on
    the pdf-labelled graphs."""
    exp = os.path.join(fixture["root"], "exp_" + opt[0][2:] + "_" + opt[1].replace(".", ""))
    args = _args(fixture, exp, "--num-epochs", "1", *opt)
    if opt[0] == "--trans-mdl":
        mdl, scp = _transition_id_graphs(fixture, os.path.join(fixture["root"]))
        args = _args(fixture, exp, "--num-epochs", "1", "--trans-mdl", mdl)
        args[args.index("--fst-scp") + 1] = scp
        base = os.path.join(fixture["root"], "exp_pdf_labels")
        assert train_asr.main(_args(fixture, base, "--num-epochs", "1")) == 0
    assert train_asr.main(args) == 0
    logged = _metrics(exp)
    assert [r["step"] for r in logged] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in logged for k in ("chain_objf", "loss", "vq_loss")
               if k in r)
    model_id = "asrbn_tdnnf_wav2vec2" if "wav2vec2" in opt[1] else "asrbn_tdnnf"
    model, meta = _served(exp, model_id)
    bp = meta["build_params"]
    if opt[1] == "tdnnf_dp":
        assert bp["bottleneck"] == "dp" and model.cfg.epsilon == 1.0
    elif opt[1] == "tdnnf_wav2vec2_vq":
        assert bp["bottleneck"] == "vq" and bp["wav2vec2"]["hidden_size"] == 16
        assert tuple(bp["kernel_size_list"]) == (3, 3, 3)
    elif opt[0] == "--compute-dtype":
        assert bp["compute_dtype"] == "bfloat16"
    else:
        for ours, ref in zip(logged, _metrics(base)):
            assert {k: v for k, v in ours.items() if k != "t"} == \
                {k: v for k, v in ref.items() if k != "t"}


def test_cli_trains_with_augmentation(fixture, tmp_path):
    """--augmentation with noise and RIR databases that the test writes (the
    .json beside each named csv, as satpu's load_augmentation reads them)."""
    from augment_fixture import write_aug_dbs

    aug = write_aug_dbs(str(tmp_path))
    exp = os.path.join(fixture["root"], "exp_aug")
    assert train_asr.main(_args(fixture, exp, "--num-epochs", "1", "--augmentation",
                                aug["inline"])) == 0
    assert _steps(exp) == [1, 2, 3]
    assert os.path.exists(os.path.join(exp, "final.ckpt"))


@pytest.mark.parametrize("opts", [
    ("--model", "tdnnf_spkadv", "--freeze-encoder", "true"),
    ("--model", "tdnnf_spkadv", "--adversarial", "false"),
    ("--model", "tdnnf_wav2vec2_dp", "--dp-epsilon", "2.0"),
    ("--model", "tdnnf_wav2vec2", "--wav2vec2-size", "base")],
    ids=["freeze_encoder", "adversarial", "dp_epsilon", "wav2vec2_size"])
def test_variant_options_parse_and_their_models_raise(fixture, opts, tiny_wav2vec2):
    """The variants' options parse, and their models (which this test once
    held to NotImplementedError) train 3 steps and are served: the
    speaker-adversarial net with its targets from utt2spk (frozen below its
    heads with ``freeze_encoder``: those weights stay at the init), the
    wav2vec2 nets with the DP bottleneck and the base-style front."""
    from satpu_torch import infer_helper
    from satpu_torch.bin.train_asr import TrainAsrOpts

    parsed = TrainAsrOpts().load_from_args(list(opts))
    assert str(getattr(parsed, opts[2][2:].replace("-", "_"))).lower() in (opts[3], "2.0")
    exp = os.path.join(fixture["root"], "exp_variant_" + opts[2][2:])
    assert train_asr.main(_args(fixture, exp, "--num-epochs", "1", *opts)) == 0
    logged = _metrics(exp)
    assert [r["step"] for r in logged] == [1, 2, 3]
    model_id = ("asrbn_tdnnf_spkadv" if opts[1] == "tdnnf_spkadv" else "asrbn_tdnnf_wav2vec2")
    model, meta = _served(exp, model_id)
    bp = meta["build_params"]
    if opts[1] == "tdnnf_spkadv":
        assert bp["num_speakers"] == 3 and bp["adversarial"] == (opts[2] != "--adversarial")
        assert all(np.isfinite(r["spkadv_loss"]) and 0 <= r["spkadv_accuracy"] <= 1
                   for r in logged)
    if opts[2] == "--freeze-encoder":
        init = infer_helper.build_model(model_id, device="cpu", seed=0, **bp).state_dict()
        got = model.state_dict()
        trunk = [k for k in got if k.startswith("acoustic.") and ".weight" in k
                 and not any(h in k for h in ("prefinal_", "chain_output", "xent_output"))]
        assert trunk and all(torch.equal(got[k], init[k]) for k in trunk)
        assert not torch.equal(got["asi_emb.weight"], init["asi_emb.weight"])
    if opts[2] == "--dp-epsilon":
        assert bp["bottleneck"] == "dp" and model.cfg.epsilon == 2.0
    if opts[2] == "--wav2vec2-size":
        assert bp["wav2vec2"]["feat_extract_norm"] == "group"
        assert not bp["wav2vec2"]["do_stable_layer_norm"]


def test_freeze_encoder_needs_spkadv(fixture):
    """satpu refuses --freeze-encoder without tdnnf_spkadv
    (satpu/bin/train_asr.py:248-252)."""
    exp = os.path.join(fixture["root"], "exp_freeze")
    with pytest.raises(ValueError, match="tdnnf_spkadv"):
        train_asr.main(_args(fixture, exp, "--freeze-encoder", "true"))
    assert not os.path.exists(exp)


@pytest.mark.parametrize("layers", [0, 4])
def test_wav2vec2_layers_cuts_the_front_in_depth(layers):
    """``--wav2vec2-layers`` keeps the size's widths and sets its transformer
    depth (0: the size's own 24), in the build parameters a checkpoint
    records."""
    from satpu_torch.bin.train_asr import TrainAsrOpts, build_params_for
    from satpu_torch.models.wav2vec2 import Wav2Vec2Config

    opts = TrainAsrOpts().load_from_args(["--model", "tdnnf_wav2vec2_vq", "--num-pdfs", "40",
                                          "--wav2vec2-layers", str(layers)])
    model_id, params = build_params_for(opts)
    large = dataclasses.asdict(Wav2Vec2Config.large())
    assert model_id == "asrbn_tdnnf_wav2vec2"
    assert params["wav2vec2"] == dict(large, num_hidden_layers=layers or 24)


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


def test_augmented_egs_batches_match_satpu(fixture, tmp_path):
    """EgsDataset.load_batch with every augmentation key (two a eg) from the
    same seed: the same augmented batch arrays as satpu's, bit for bit, over
    every batch of two epochs (the dataset's random.Random carries over)."""
    from augment_fixture import write_aug_dbs
    from satpu.chain.dataset import EgsDataset as JEgs
    from satpu.ops.augment import load_augmentation as jload
    from satpu_torch.chain.dataset import BucketBatchSampler, EgsDataset
    from satpu_torch.ops.augment import load_augmentation

    aug = write_aug_dbs(str(tmp_path))["inline"]
    data = fixture["data"]
    args = (os.path.join(data, "wav.scp"), fixture["fst_scp"], os.path.join(data, "utt2len"))
    tp, noise_db, rir_db = load_augmentation(aug)
    assert (tp, noise_db, rir_db) == jload(aug)
    ds = EgsDataset(*args, transform_pipeline=tp, noise_db=noise_db, rir_db=rir_db, seed=7)
    jds = JEgs(*args, transform_pipeline=tp, noise_db=noise_db, rir_db=rir_db, seed=7)
    sampler = BucketBatchSampler(ds, 2, seed=3)
    n = 0
    for epoch in range(2):
        sampler.set_epoch(epoch)
        for batch in sampler:
            w, jw = ds.load_batch(batch)[0], jds.load_batch(batch)[0]
            np.testing.assert_array_equal(w, jw)
            n += 1
    assert n == 6
    plain = EgsDataset(*args).load_batch(batch)[0]
    assert not np.array_equal(plain, w)  # the batch was augmented
