"""satpu_torch AnonymizationNet against satpu end to end on the CPU (tiny
widths, full layer structure), and the port's checkpoint round trip."""
import numpy as np
import pytest
import torch

import jax

from torch_parity import ANON_TINY, ASRBN_TINY, jax_variables_numpy, rel_err


@pytest.fixture(scope="module")
def anon():
    from satpu.models.anonymizer import AnonymizationNet as JNet
    from satpu.models.anonymizer import AnonymizerConfig as JCfg
    from satpu.models.asrbn import TDNNFNetConfig as JTC

    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    f0 = (np.abs(rng.standard_normal((2, 50))) * 30 + 100).astype(np.float32)
    f0[:, :6] = 0.0
    f0[1, 30:40] = 0.0
    tid = np.array([0, 2], np.int32)
    jnet = JNet(JCfg(asrbn=JTC(**ASRBN_TINY), **ANON_TINY))
    variables = jax_variables_numpy(
        jnet.init(jax.random.PRNGKey(0), wav, f0, tid, method=jnet.convert))
    ref = np.asarray(jnet.apply(variables, wav, f0, tid, method=jnet.convert))
    ref_bn = np.asarray(jnet.apply(variables, wav, method=jnet.get_bn))
    return wav, f0, tid, variables, ref, ref_bn


def _port(variables, **cfg):
    from satpu_torch.models.anonymizer import AnonymizationNet, AnonymizerConfig
    from satpu_torch.models.asrbn import TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables

    net = AnonymizationNet(AnonymizerConfig(asrbn=TDNNFNetConfig(**ASRBN_TINY),
                                            **ANON_TINY, **cfg)).eval()
    missing, unexpected = net.load_state_dict(from_satpu_variables(variables), strict=False)
    # satpu's convert-path init creates no chain/xent heads and no after-BN
    # stage: exactly those stay unloaded
    assert not unexpected
    assert all(k.startswith(("bn_extractor.tdnnfs_after.", "bn_extractor.prefinal_",
                             "bn_extractor.chain_output.", "bn_extractor.xent_output.",
                             "bn_extractor.tdnnfs.10.tdnn.linearA.",
                             "bn_extractor.tdnnfs.10.bn."))
               for k in missing), missing
    return net


def test_convert_f32_matches_satpu(anon):
    """the whole convert path at f32: rel <= 1e-4 on the waveform."""
    wav, f0, tid, variables, ref, _ = anon
    net = _port(variables)
    with torch.no_grad():
        out = net.convert(torch.from_numpy(wav), torch.from_numpy(f0),
                          torch.from_numpy(tid)).numpy()
    assert out.shape == ref.shape == (2, 16001)
    assert rel_err(out, ref) <= 1e-4, rel_err(out, ref)


def test_get_bn_layout_matches_satpu(anon):
    wav, _, _, variables, _, ref_bn = anon
    net = _port(variables)
    with torch.no_grad():
        bn = net.get_bn(torch.from_numpy(wav)).numpy()
    assert bn.shape == ref_bn.shape  # [B, C, T_bn]
    assert rel_err(bn, ref_bn) <= 1e-4


def test_convert_bf16_serving_policy_within_tolerance(anon):
    """bf16 generator convs + TDNNF matmuls vs satpu f32: rel <= 2e-2 (the
    VQ codes of this tiny net do not flip under bf16 here)."""
    wav, f0, tid, variables, ref, _ = anon
    net = _port(variables, compute_dtype="bfloat16")
    with torch.no_grad():
        out = net.convert(torch.from_numpy(wav), torch.from_numpy(f0),
                          torch.from_numpy(tid)).numpy()
    assert rel_err(out, ref) <= 2e-2, rel_err(out, ref)


def test_checkpoint_round_trip(tmp_path, anon):
    from satpu_torch import infer_helper

    _, _, _, variables, _, _ = anon
    net = _port(variables)
    build = {"asrbn": dict(ASRBN_TINY), **ANON_TINY}
    path = str(tmp_path / "anon.pt")
    infer_helper.save_model(path, "anonymizer_tdnnf_hifigan", build, net.state_dict(),
                            extra_meta={"speakers": ["a", "b", "c"]})
    model, meta = infer_helper.load_model(path, device="cpu",
                                          option_args={"compute_dtype": "bfloat16"})
    assert meta["speakers"] == ["a", "b", "c"]
    assert model.cfg.compute_dtype == "bfloat16"
    assert model.cfg.asrbn == net.cfg.asrbn
    for k, v in net.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_build_model_seeded_init_is_reproducible():
    from satpu_torch import infer_helper

    build = {"asrbn": dict(ASRBN_TINY), **ANON_TINY}
    a = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu", seed=3, **build)
    b = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu", seed=3, **build)
    c = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu", seed=4, **build)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert all(torch.isfinite(v).all() for v in sa.values())
