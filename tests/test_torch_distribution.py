"""Model distribution in the port, on the CPU: the reference ``final.pt``
importer, the hub, the ``import_model`` CLI, fail-fast job fan-out and
``anonymize --num-procs``.

- ``infer_helper.import_reference_checkpoint`` equals satpu's importer
  followed by ``convert.from_satpu_variables``: the same tensors exactly,
  the same build params and speaker table, for an anonymizer (the
  extractor at its default widths with a VQ-8 bottleneck and 16 outputs,
  a 32-channel generator over 3 speakers) and a bare extractor. The
  ``final.pt`` files are written here under the names and in the shapes
  ``satpu/models/convert.py`` reads (random values from a numpy seed): the
  reference's TDNN-F ``Sequential`` interleaves a dropout, so its layers
  are ``tdnnfs.{2k}`` / ``tdnnfs_after.{2k}``, and its VQ buffers
  ``quant._embedding.weight`` / ``_ema_cluster_size`` / ``_ema_w``;
- the hub: satpu's tags, file names, release URLs and option-arg parsing;
  resolve's errors; ``load`` of a zoo tag with option args;
- the ``import_model`` CLI installs into ``$SATPU_ZOO`` and the tag then
  loads through ``hub.load`` with ``+f0-transformation=...``, serving the
  imported weights;
- ``utils.jobs`` is satpu's: ``run_parallel_failfast`` terminates the
  other jobs when one fails;
- ``anonymize --num-procs 2 --device cpu`` writes the same wavs as one
  process, and a run whose shards cannot start exits non-zero.
"""
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

from torch_parity import harmonic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANON_REF = dict(num_speakers=3, upsample_initial_channel=32,
                asrbn=dict(output_dim=16, bottleneck="vq", codebook_size=8))
TAG = "hifigan_bn_tdnnf_600h_vq_48_v1"
UTT2SPK = {"u1": "s2", "u2": "s1", "u3": "s3", "u4": "s1"}


def _reference_name(key: str) -> str:
    """The port's key -> the reference's (the names satpu/models/convert.py
    reads)."""
    key = re.sub(r"(tdnnfs|tdnnfs_after)\.(\d+)\.",
                 lambda m: f"{m.group(1)}.{2 * int(m.group(2))}.", key)
    for new, old in (("vq.embedding", "quant._embedding.weight"),
                     ("vq.ema_cluster_size", "quant._ema_cluster_size"),
                     ("vq.ema_w", "quant._ema_w")):
        key = key.replace("bottleneck_func." + new, "bottleneck_func." + old)
    return key


def _write_reference(path, model_id, build_params, seed, extra_params=None):
    """A reference-format final.pt: {base_model_state_dict, base_model_params}
    with the port model's tensors under the reference's names, random."""
    from satpu_torch import infer_helper

    model = infer_helper.build_model(model_id, device="cpu", seed=None, **build_params)
    rng = np.random.default_rng(seed)

    def draw(key, shape):  # batch-norm variances positive
        x = rng.standard_normal(shape)
        return np.abs(x) + 0.5 if key.endswith("running_var") else x

    sd = {_reference_name(k): torch.from_numpy(draw(k, tuple(v.shape)).astype(np.float32))
          for k, v in model.state_dict().items()}
    # tensors the importers skip
    sd["bn_extractor.tdnnfs.20.bn.num_batches_tracked" if model_id.startswith("anon")
       else "tdnnfs.20.bn.num_batches_tracked"] = torch.tensor(5)
    torch.save({"base_model_state_dict": sd, "base_model_params": extra_params or {}}, path)
    return sd


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    anon, asrbn = str(d / "anon_final.pt"), str(d / "asrbn_final.pt")
    _write_reference(anon, "anonymizer_tdnnf_hifigan", ANON_REF, 0, {"utt2spk": UTT2SPK})
    _write_reference(asrbn, "asrbn_tdnnf", dict(output_dim=40), 1, {"output_dim": 40})
    return {"anonymizer": anon, "asrbn": asrbn}


@pytest.mark.parametrize("kind", ["anonymizer", "asrbn"])
def test_import_reference_checkpoint_matches_satpus(reference, kind, tmp_path):
    from satpu.infer_helper import import_reference_checkpoint as jimport
    from satpu.utils.checkpoint import load_checkpoint as jload
    from satpu_torch import infer_helper
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.utils.checkpoint import load_checkpoint

    out, jout = str(tmp_path / "port.pt"), str(tmp_path / "satpu.ckpt")
    assert infer_helper.import_reference_checkpoint(reference[kind], out, kind=kind) == out
    jimport(reference[kind], jout, kind=kind)
    meta, sd = load_checkpoint(out)
    jmeta, jstate = jload(jout)
    want = from_satpu_variables(jstate["variables"])
    assert meta == jmeta
    assert set(sd) == set(want)
    for k in want:
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy(), err_msg=k)
    if kind == "anonymizer":
        assert meta["speakers"] == ["s1", "s2", "s3"]
        assert meta["build_params"] == dict(ANON_REF, bn_dim=256)
    else:
        assert meta["build_params"] == {"output_dim": 40}
    # the port also reads satpu's own import of the file
    model, jmeta2 = infer_helper.load_model(jout, device="cpu")
    assert jmeta2 == meta
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)


def test_import_reference_checkpoint_refuses_a_foreign_file(tmp_path):
    from satpu_torch import infer_helper

    path = str(tmp_path / "final.pt")
    torch.save({"base_model_state_dict": {"chain_output.weight": torch.zeros(4, 1024)}}, path)
    with pytest.raises(KeyError, match="lacks"):
        infer_helper.import_reference_checkpoint(path, str(tmp_path / "o.pt"), kind="asrbn")
    with pytest.raises(ValueError):
        infer_helper.import_reference_checkpoint(path, str(tmp_path / "o.pt"), kind="vocoder")
    assert not (tmp_path / "o.pt").exists()


def test_hub_tables_and_option_args_are_satpus():
    import satpu.hub as jhub
    from satpu_torch import hub

    assert hub.MODEL_ZOO == jhub.MODEL_ZOO and len(hub.MODEL_ZOO) == 16
    for tag in hub.MODEL_ZOO:
        if tag == "asv_eval_vox1_ecapa_tdnn":
            with pytest.raises(KeyError):
                hub.reference_release_url(tag)
        else:
            assert hub.reference_release_url(tag + "+x=1") == jhub.reference_release_url(tag)
    for tag in ["a", "a+f0-transformation=quant_16", "a+f0-transformation=quant_16+x=1+bare",
                "a+k=v=w", "a+"]:
        assert hub._parse_option_args(tag) == jhub._parse_option_args(tag)
    assert hub._parse_option_args(TAG + "+f0-transformation=quant_16_awgn_2") == (
        TAG, {"f0_transformation": "quant_16_awgn_2"})


def test_hub_resolve_errors(tmp_path, monkeypatch):
    from satpu_torch import hub

    monkeypatch.setenv("SATPU_ZOO", str(tmp_path / "zoo"))
    assert hub.zoo_dir() == str(tmp_path / "zoo")
    with pytest.raises(KeyError, match="unknown model tag"):
        hub.resolve("no_such_tag+f0-transformation=quant_16")
    with pytest.raises(FileNotFoundError, match="no recorded URL"):
        hub.resolve(TAG)
    with pytest.raises(FileNotFoundError):
        hub.load(TAG + "+f0-transformation=quant_16", device="cpu")
    assert not (tmp_path / "zoo").exists()  # nothing downloaded, nothing made
    existing = tmp_path / "m.pt"
    existing.write_bytes(b"")
    assert hub.resolve(str(existing)) == str(existing)
    monkeypatch.delenv("SATPU_ZOO")
    assert hub.zoo_dir() == os.path.join(os.path.expanduser("~"), ".cache", "satpu")


def test_import_model_cli_then_hub_load(reference, tmp_path, monkeypatch):
    from satpu_torch import hub, infer_helper
    from satpu_torch.bin import import_model

    zoo = tmp_path / "zoo"
    monkeypatch.setenv("SATPU_ZOO", str(zoo))
    assert import_model.main(["--torch-checkpoint", reference["anonymizer"], "--tag", TAG,
                              "--device", "cpu"]) == 0
    installed = zoo / hub.MODEL_ZOO[TAG][1]
    assert installed.exists()
    direct = str(tmp_path / "direct.pt")
    infer_helper.import_reference_checkpoint(reference["anonymizer"], direct)
    model, meta = hub.load(TAG + "+f0-transformation=quant_16", device="cpu")
    ref, _ = infer_helper.load_model(direct, device="cpu")
    assert model.cfg.f0_transformation == "quant_16" and ref.cfg.f0_transformation == ""
    assert meta["speakers"] == ["s1", "s2", "s3"]
    assert all(torch.equal(model.state_dict()[k], v) for k, v in ref.state_dict().items())
    wav, _ = harmonic(8000, 150.0, seed=3)
    x = torch.from_numpy(wav[None])
    f0 = torch.full((1, 25), 140.0)
    tid = torch.tensor([1])
    with torch.no_grad():
        out = model.eval().convert(x, f0, tid)
        ref_q = ref.eval()
        ref_q.cfg = model.cfg  # the same transformation on the directly imported weights
        want = ref_q.convert(x, f0, tid)
    assert torch.isfinite(out).all() and torch.equal(out, want)
    # --kind from the tag, --out instead of the zoo
    out_path = str(tmp_path / "bn.pt")
    assert import_model.main(["--torch-checkpoint", reference["asrbn"], "--tag",
                              "bn_tdnnf_600h_vq_48_v1", "--out", out_path,
                              "--device", "cpu"]) == 0
    assert infer_helper.load_model(out_path, device="cpu")[1]["model_id"] == "asrbn_tdnnf"
    with pytest.raises(SystemExit):  # neither --tag nor --out
        import_model.main(["--torch-checkpoint", reference["asrbn"], "--device", "cpu"])


def test_jobs_module_is_satpus():
    from satpu_torch.utils import jobs

    with open(os.path.join(ROOT, "satpu", "utils", "jobs.py")) as f:
        ref = f.read()
    with open(jobs.__file__) as f:
        got = f.read()

    def body(src):  # everything after the module docstring
        return src[src.index('"""', 3) + 3:]

    assert body(got) == body(ref)


def test_run_parallel_failfast_terminates_the_others():
    from satpu_torch.utils.jobs import run_parallel_failfast

    t0 = time.monotonic()
    rcs = run_parallel_failfast([[sys.executable, "-c", "import time; time.sleep(60)"],
                                 [sys.executable, "-c", "import sys; sys.exit(3)"],
                                 [sys.executable, "-c", "import time; time.sleep(60)"]],
                                poll=0.1)
    assert time.monotonic() - t0 < 30
    assert rcs[1] == 3 and rcs[0] < 0 and rcs[2] < 0  # terminated by a signal
    assert run_parallel_failfast([[sys.executable, "-c", "pass"]] * 2, poll=0.1) == [0, 0]


@pytest.fixture(scope="module")
def anon_dir(tmp_path_factory):
    from satpu_torch import infer_helper
    from satpu_torch.utils import kaldi_data
    from torch_parity import ANON_TINY, ASRBN_TINY

    root = tmp_path_factory.mktemp("procs")
    build = {"asrbn": dict(ASRBN_TINY), **ANON_TINY}
    model = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu", seed=0, **build)
    ckpt = str(root / "anon.pt")
    infer_helper.save_model(ckpt, "anonymizer_tdnnf_hifigan", build, model.state_dict(),
                            extra_meta={"speakers": ["a", "b", "c"]})
    data = str(root / "data")
    os.makedirs(data)
    wav_scp, utt2spk = {}, {}
    for i, (n, f0) in enumerate([(9000, 120.0), (12000, 180.0), (15500, 230.0),
                                 (10500, 140.0), (8000, 200.0)]):
        utt = f"s{i % 2}-u{i}"
        wav_scp[utt] = str(root / f"{utt}.wav")
        kaldi_data.write_wav(wav_scp[utt], harmonic(n, f0, seed=i)[0], 16000)
        utt2spk[utt] = f"s{i % 2}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(data, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(data, "utt2spk"))
    return ckpt, data, wav_scp


def test_anonymize_num_procs_writes_the_one_process_wavs(anon_dir, monkeypatch):
    """Each utterance alone in its batch (--batch-size 1), so that its
    padding and its bucket are the same in both runs; constant target."""
    from satpu_torch.bin import anonymize
    from satpu_torch.utils import kaldi_data

    ckpt, data, wav_scp = anon_dir
    monkeypatch.chdir(os.path.dirname(data))  # the children find the package from any dir
    common = ["--checkpoint", ckpt, "--directory", data, "--device", "cpu", "--batch-size", "1",
              "--target-constant-spkid", "b"]
    out = {}
    for name, extra in (("one", []), ("two", ["--num-procs", "2"])):
        assert anonymize.main(common + ["--new-datadir-suffix", f"_{name}"] + extra) == 0
        scp = kaldi_data.read_wav_scp(data + f"_{name}/wav.scp")
        out[name] = {u: kaldi_data.load_wav_from_scp(p)[0][0] for u, p in scp.items()}
    assert sorted(out["one"]) == sorted(out["two"]) == sorted(wav_scp)
    for u in wav_scp:
        assert len(out["two"][u]) == len(kaldi_data.load_wav_from_scp(wav_scp[u])[0][0])
        np.testing.assert_array_equal(out["two"][u], out["one"][u], err_msg=u)
    assert {f"wav_shard{k}.scp" for k in range(2)} <= set(os.listdir(data + "_two"))


def test_anonymize_num_procs_fails_when_a_shard_fails(anon_dir, tmp_path):
    from satpu_torch.bin import anonymize

    _, data, _ = anon_dir
    t0 = time.monotonic()
    rc = anonymize.main(["--checkpoint", str(tmp_path / "missing.pt"), "--directory", data,
                         "--device", "cpu", "--num-procs", "2", "--new-datadir-suffix", "_bad"])
    assert rc != 0 and time.monotonic() - t0 < 120
    assert not os.path.exists(data + "_bad")
