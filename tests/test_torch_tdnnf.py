"""satpu_torch TDNN-F ASR-BN against satpu on the CPU at f32, weights
carried across by the weight bridge: bottleneck extraction (VQ), the
chain/xent heads (with the /1.5 splice), masked features, frame counts."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import ASRBN_TINY, jax_variables_numpy, rel_err


@pytest.fixture(scope="module")
def nets():
    from satpu.models.asrbn import TDNNFNet as JNet
    from satpu.models.asrbn import TDNNFNetConfig as JCfg
    from satpu_torch.models.asrbn import TDNNFNet, TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables

    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 12000)) * 0.1).astype(np.float32)
    jnet = JNet(JCfg(**ASRBN_TINY))
    variables = jax_variables_numpy(jnet.init(jax.random.PRNGKey(0), wav[:, :8000]))
    # non-trivial BN statistics
    for layer in variables["batch_stats"].values():
        layer["bn"]["mean"] = rng.standard_normal(layer["bn"]["mean"].shape).astype(np.float32)
        layer["bn"]["var"] = rng.random(layer["bn"]["var"].shape).astype(np.float32) + 0.5
    net = TDNNFNet(TDNNFNetConfig(**ASRBN_TINY)).eval()
    net.load_state_dict(from_satpu_variables(variables))
    return jnet, variables, net, wav


def _codes(bn, codebook):
    """nearest codebook row of every frame [B, T, C] -> [B, T]."""
    d = ((bn[..., None, :] - codebook[None, None]) ** 2).sum(-1)
    return d.argmin(-1)


def test_bridge_fills_every_tensor(nets):
    from satpu_torch.models.convert import from_satpu_variables

    _, variables, net, _ = nets
    assert set(from_satpu_variables(variables)) == set(net.state_dict())


def test_extract_bn_f32_matches_satpu(nets):
    """rel <= 1e-4 and 100% VQ index agreement."""
    jnet, variables, net, wav = nets
    ref = np.asarray(jnet.apply(variables, wav, method=jnet.extract_bn))
    with torch.no_grad():
        out = net.extract_bn(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) <= 1e-4, rel_err(out, ref)
    codebook = variables["vq_stats"]["vq_bottleneck"]["vq"]["embedding"]
    agree = np.mean(_codes(out, codebook) == _codes(ref, codebook))
    assert agree == 1.0, f"VQ index agreement {agree}"


def test_loglikes_f32_match_satpu(nets):
    """chain and xent heads, through the /1.5 splice and bypass: rel <= 1e-4."""
    jnet, variables, net, wav = nets
    ref_chain, ref_xent = (np.asarray(a) for a in jnet.apply(variables, wav))
    with torch.no_grad():
        chain, xent = (a.numpy() for a in net(torch.from_numpy(wav)))
    assert chain.shape == ref_chain.shape and xent.shape == ref_xent.shape
    assert rel_err(chain, ref_chain) <= 1e-4
    assert rel_err(xent, ref_xent) <= 1e-4


def test_masked_features_match_satpu(nets):
    """zero-padded batch with valid lengths: masked CMVN + replicate tail."""
    jnet, variables, net, wav = nets
    lengths = np.array([12000, 7000], np.int32)
    ref = np.asarray(jnet.apply(variables, wav, jnp.asarray(lengths), method=jnet.features))
    out = net.features(torch.from_numpy(wav), torch.from_numpy(lengths)).numpy()
    assert np.abs(out - ref).max() <= 1e-3


@pytest.mark.parametrize("s", [1.5, 2.0])
def test_splice_frames_matches_satpu(s):
    from satpu.models.tdnnf import splice_frames as jsplice
    from satpu_torch.models.tdnnf import splice_frames

    x = np.random.default_rng(1).standard_normal((2, 11, 6)).astype(np.float32)  # [B, T, D]
    ref = np.asarray(jsplice(jnp.asarray(x), 3, s))
    out = splice_frames(torch.from_numpy(x).transpose(1, 2), 3, s).transpose(1, 2).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n", [8000, 8160, 12345, 16000])
def test_frame_count_helpers_match_the_net(nets, n):
    from satpu_torch.models.asrbn import bn_num_frames, output_num_frames

    _, _, net, _ = nets
    wav = torch.zeros(1, n)
    with torch.no_grad():
        assert net.extract_bn(wav).shape[1] == bn_num_frames(n)
        assert net(wav)[0].shape[1] == output_num_frames(n, net.cfg)
