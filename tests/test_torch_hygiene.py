"""satpu_torch stands alone: no file of the port (nor chip_smoke.py)
imports jax, flax or satpu, importing its CLIs loads no jax, its copies of
satpu's numpy-only modules import no torch either (``COPIED``; ROADMAP
"Copied so far"), and its entry points refuse to run on the CPU unless
asked to (``prepare_data`` is host-only, as satpu's is)."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "satpu")
# the port's copies of satpu's numpy-only modules (whole, or the parts the
# port needs); they run on the host
COPIED = ("utils/kaldi_data.py", "utils/config.py", "utils/wer.py", "utils/scp_io.py",
          "utils/feature_cache.py", "utils/schedules.py", "chain/fst.py", "chain/lattice.py",
          "chain/decoder.py", "chain/hmm.py", "chain/prep.py", "bin/prepare_data.py",
          "sidekit/scoring.py", "sidekit/dataset.py", "hifigan/dataset.py", "utils/jobs.py",
          "bin/preprocess_audio.py", "bin/prepare_vctk.py", "bin/prepare_aug.py")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "satpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_flax_or_satpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_are_numpy_only(rel):
    path = os.path.join(ROOT, "satpu_torch", rel)
    assert "torch" not in set(_imported_roots(path)), rel


def test_cli_import_leaves_jax_unloaded():
    code = ("import sys, satpu_torch.bin.anonymize, satpu_torch.bin.pipeline, "
            "satpu_torch.infer_helper, satpu_torch.bin.train_asr, satpu_torch.chain, "
            "satpu_torch.chain.trainer, satpu_torch.chain.dataset, satpu_torch.chain.prep, "
            "satpu_torch.bin.eval_anon, satpu_torch.sidekit.xvector, "
            "satpu_torch.chain.decoder, satpu_torch.native, satpu_torch.bin.train_vc, "
            "satpu_torch.hifigan.trainer, satpu_torch.hifigan.dataset, satpu_torch.ops.mel, "
            "satpu_torch.utils.feature_cache, satpu_torch.bin.train_asv, "
            "satpu_torch.sidekit.dataset, satpu_torch.sidekit.trainer, satpu_torch.ops.augment, "
            "satpu_torch.utils.schedules, satpu_torch.bin.prepare_data, satpu_torch.chain.hmm, "
            "satpu_torch.models.wav2vec2, satpu_torch.models.spkadv, "
            "satpu_torch.models.torchlayers, satpu_torch.models.wavlm, satpu_torch.hub, "
            "satpu_torch.bin.import_model, satpu_torch.utils.flax_msgpack, "
            "satpu_torch.utils.jobs, satpu_torch.parallel, satpu_torch.parallel.mesh, "
            "satpu_torch.parallel.multihost, satpu_torch.bin.export_model, "
            "satpu_torch.bin.diff_checkpoints, satpu_torch.bin.parity, "
            "satpu_torch.bin.preprocess_audio, satpu_torch.bin.prepare_vctk, "
            "satpu_torch.bin.prepare_aug, satpu_torch.utils.metrics\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'satpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_build_model_defaults_to_cuda(monkeypatch):
    from satpu_torch import infer_helper
    from torch_parity import ANON_TINY, ASRBN_TINY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_helper.build_model("anonymizer_tdnnf_hifigan", asrbn=dict(ASRBN_TINY),
                                 **ANON_TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_helper.load_model(os.path.join(ROOT, "no-such.pt"))
    model = infer_helper.build_model("asrbn_tdnnf", device="cpu", **ASRBN_TINY)
    assert next(model.parameters()).device.type == "cpu"


def test_asv_and_eval_anon_default_to_cuda(monkeypatch, tmp_path):
    from satpu_torch import infer_helper
    from satpu_torch.bin import eval_anon
    from torch_parity import XV_TINY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_helper.build_model("asv_xvector", **XV_TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_anon.main(["--results", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()
    model = infer_helper.build_model("asv_xvector", device="cpu", **XV_TINY)
    assert next(model.parameters()).device.type == "cpu"


def test_train_vc_defaults_to_cuda(monkeypatch, tmp_path):
    from satpu_torch.bin import train_vc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vc.main(["--train-set", str(tmp_path / "data"), "--dirname", str(tmp_path / "exp")])
    assert not (tmp_path / "exp").exists()


def test_train_asv_defaults_to_cuda(monkeypatch, tmp_path):
    from satpu_torch.bin import train_asv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_asv.main(["--train-set", str(tmp_path / "data"), "--dirname", str(tmp_path / "exp")])
    assert not (tmp_path / "exp").exists()


def test_train_asr_variants_default_to_cuda(monkeypatch, tmp_path):
    from satpu_torch.bin import train_asr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("tdnnf_wav2vec2_vq", "tdnnf_spkadv", "tdnnf_dp"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_asr.main(["--model", model, "--dp-epsilon", "1.0",
                            "--dirname", str(tmp_path / "exp")])
    assert not (tmp_path / "exp").exists()


def test_import_model_and_hub_default_to_cuda(monkeypatch, tmp_path):
    from satpu_torch import hub
    from satpu_torch.bin import import_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SATPU_ZOO", str(tmp_path / "zoo"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_model.main(["--torch-checkpoint", str(tmp_path / "final.pt"),
                           "--tag", "bn_tdnnf_600h_vq_48_v1"])
    assert not (tmp_path / "zoo").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hub.load(os.path.join(ROOT, "no-such.pt"))
