"""The port's AOT export (``hub.export_convert`` / ``export_fn`` /
``load_exported`` and ``bin/export_model``) on the CPU: a tiny anonymizer's
F0 + convert at B=2 x 1 s exported by the CLI to a ``.pt2`` program that
names the ``satpu_torch::shc_band`` and ``satpu_torch::viterbi_path`` ops,
loaded and run in a fresh process that imports only those ops'
registration: within 1e-6 of eager, and satpu's convert on the same input
and F0 at the convert parity tolerance (rel 1e-4); an extractor's loglikes
exported and loaded likewise; each op's fake (export-time) result has the
plain version's shape and dtype (``torch.library.opcheck``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from torch_parity import ANON_TINY, ASRBN_TINY, jax_variables_numpy, rel_err, yaapt_batch_signals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a fresh process: the op's registration, and no model code
RUN = """
import sys, torch
import satpu_torch.ops.yaapt
prog = torch.export.load(sys.argv[1]).module()
io = torch.load(sys.argv[2])
with torch.no_grad():
    out = prog(*io["args"])
torch.save(out, sys.argv[3])
print(sorted(m for m in sys.modules if m.startswith("satpu")))
"""


def _run_fresh(pt2, args, tmp_path):
    torch.save({"args": args}, str(tmp_path / "in.pt"))
    proc = subprocess.run([sys.executable, "-c", RUN, pt2, str(tmp_path / "in.pt"),
                           str(tmp_path / "out.pt")], cwd=ROOT, capture_output=True,
                          text=True, timeout=180, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the op's registration, the kernel boundary its wrapper launches through
    # and the recorder that counts the launches (``satpu_torch.utils``
    # imports its host utilities beside them): no model
    assert proc.stdout.split("\n")[-2] == str([
        "satpu_torch", "satpu_torch.ops", "satpu_torch.ops.yaapt", "satpu_torch.utils",
        "satpu_torch.utils.checkpoint", "satpu_torch.utils.config",
        "satpu_torch.utils.cuda_build", "satpu_torch.utils.kaldi_data",
        "satpu_torch.utils.scp_io", "satpu_torch.utils.trace"])
    return torch.load(str(tmp_path / "out.pt"))


def _ops(pt2):
    program = torch.export.load(pt2)
    return {str(n.target) for _, m in program.graph_module.named_modules()
            if hasattr(m, "graph") for n in m.graph.nodes if n.op == "call_function"}


def test_convert_exports_and_runs_without_the_model(tmp_path):
    from satpu.models.anonymizer import AnonymizationNet as JNet
    from satpu.models.anonymizer import AnonymizerConfig as JCfg
    from satpu.models.asrbn import TDNNFNetConfig as JTC
    from satpu_torch import infer_helper
    from satpu_torch.bin import export_model
    from satpu_torch.models.anonymizer import AnonymizationNet, AnonymizerConfig
    from satpu_torch.models.asrbn import TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables

    wav = yaapt_batch_signals()[:2]
    tid = np.array([0, 2], np.int64)
    jnet = JNet(JCfg(asrbn=JTC(**ASRBN_TINY), **ANON_TINY))
    variables = jax_variables_numpy(jnet.init(
        jax.random.PRNGKey(0), wav, np.zeros((2, 50), np.float32), tid.astype(np.int32),
        method=jnet.convert))
    net = AnonymizationNet(AnonymizerConfig(asrbn=TDNNFNetConfig(**ASRBN_TINY), **ANON_TINY))
    net.load_state_dict(from_satpu_variables(variables), strict=False)
    net.eval()
    ckpt, pt2 = str(tmp_path / "anon.pt"), str(tmp_path / "convert.pt2")
    infer_helper.save_model(ckpt, "anonymizer_tdnnf_hifigan",
                            {"asrbn": dict(ASRBN_TINY), **ANON_TINY}, net.state_dict())
    assert export_model.main(["--checkpoint", ckpt, "--out", pt2, "--device", "cpu",
                              "--batch", "2", "--num-samples", str(wav.shape[1])]) == 0
    ops = _ops(pt2)
    assert "satpu_torch.shc_band.default" in ops
    assert "satpu_torch.viterbi_path.default" in ops
    w, t = torch.from_numpy(wav), torch.from_numpy(tid)
    out = _run_fresh(pt2, (w, t), tmp_path)
    with torch.no_grad():
        f0 = net.get_f0(w)
        eager = net.convert(w, f0, t)
    assert out.shape == eager.shape
    assert float((out - eager).abs().max()) <= 1e-6
    ref = np.asarray(jnet.apply(variables, wav, f0.numpy(), tid.astype(np.int32),
                                method=jnet.convert))
    assert rel_err(out.numpy(), ref) <= 1e-4


def test_loglikes_export(tmp_path):
    from satpu_torch import hub, infer_helper

    net = infer_helper.build_model("asrbn_tdnnf", device="cpu", seed=0, **ASRBN_TINY).eval()
    wav = torch.from_numpy(yaapt_batch_signals()[:2])
    pt2 = hub.export_fn(net, lambda m, w: m(w)[0], (wav,), str(tmp_path / "ll.pt2"))
    with torch.no_grad():
        eager = net(wav)[0]
    out = _run_fresh(pt2, (wav,), tmp_path)
    assert float((out - eager).abs().max()) <= 1e-6
    assert float((hub.load_exported(pt2)(wav) - eager).abs().max()) <= 1e-6


def test_export_cli_refuses_bad_arguments(tmp_path):
    from satpu_torch.bin import export_model

    assert export_model.main(["--checkpoint", "x"]) == 2
    with pytest.raises(ValueError, match="unknown kind"):
        export_model.main(["--checkpoint", "x", "--out", "y", "--kind", "nope"])


def test_shc_band_op_fake_matches_plain():
    from satpu_torch.ops.yaapt import shc_band_plain

    mag = torch.rand(5, 1045)
    args = (mag, 31, 226, 4, 21)
    torch.library.opcheck(torch.ops.satpu_torch.shc_band.default, args)
    out = torch.ops.satpu_torch.shc_band(*args)
    assert torch.equal(out, shc_band_plain(*args))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.satpu_torch.shc_band(mode.from_tensor(mag), 31, 226, 4, 21)
    assert fake.shape == out.shape and fake.dtype == out.dtype == torch.float32


def test_viterbi_path_op_fake_matches_plain():
    from satpu_torch.ops.yaapt import viterbi_path_plain

    rng = np.random.default_rng(0)
    local = torch.from_numpy(rng.integers(0, 3, (3, 6, 40)).astype(np.float32))
    trans = torch.from_numpy(rng.integers(0, 3, (3, 6, 6, 40)).astype(np.float32))
    for args in ((local, trans), (local, trans.transpose(1, 2))):
        torch.library.opcheck(torch.ops.satpu_torch.viterbi_path.default, args)
        out = torch.ops.satpu_torch.viterbi_path(*args)
        assert torch.equal(out, viterbi_path_plain(*args))
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
            fake = torch.ops.satpu_torch.viterbi_path(*(mode.from_tensor(a) for a in args))
        assert fake.shape == out.shape == (3, 40) and fake.dtype == out.dtype == torch.int64
