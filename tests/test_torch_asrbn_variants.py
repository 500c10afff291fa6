"""The ASR-BN variants of the port against satpu on the CPU, at small widths
(TDNN-F 32, bottleneck 16, a wav2vec2 front of hidden 32 with satpu's
randomized weights and norms carried across by the weight bridge):

- ``Wav2Vec2TDNNFNet`` (VQ-8): the eval forward's chain and xent outputs
  and ``extract_bn``, rel <= 1e-4, and the VQ indices of the bottleneck
  equal; its output frames over a sweep of lengths (with the real 7-conv
  geometry at narrow widths, and prepare_data's allowed lengths) equal
  satpu's and ``wav2vec2_output_num_frames``, which is the egs'
  ``output_frames`` or one more (satpu's step feeds the numerator
  ``num_frames`` and the den every network frame; the port does the same);
- ``rev_grad``: the identity forward, -alpha x the gradient backward;
- the DP bottleneck: the JAX and torch streams differ, so the port's noise
  is held to satpu's on the same uniform draw (recovered from satpu's
  output by inverting x - b sign(u) log(1 - 2|u|)), rel <= 1e-6, and the
  port's own draws to the Laplace(0, 1/epsilon) law (Kolmogorov-Smirnov
  distance <= 0.01 over 10^5 draws; mean |noise| within 2% of 1/epsilon);
- ``TDNNFNet(return_bn=True)`` and ``SpkAdvTDNNFNet`` in training mode, in
  f64 on both sides (satpu under ``jax.enable_x64``, where its fbank still
  computes in f32: the train-mode batch norms amplify that 1e-7 to 7.4e-6
  in the outputs): outputs, the bottleneck tap and the adversarial loss,
  rel <= 1e-4, the same accuracy, and the reversed gradient into satpu's
  own tap, rel <= 1e-2 (satpu's batch norms compute in f32 even under x64,
  and the train-mode half-ResNet is ill-conditioned: the bound of
  tests/test_torch_asv_trainer.py);
- the new checkpoints (``asrbn_tdnnf_wav2vec2``, ``asrbn_tdnnf_spkadv``)
  round-trip through ``infer_helper.save_model`` / ``load_model``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import jax_variables_numpy, randomize_bn, rel_err

W2V = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8),
           hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
NET = dict(hidden_dim=32, bottleneck_dim=16, prefinal_bottleneck_dim=16)
P = 24


def _w2v_nets(w2v=W2V, bottleneck="vq", seed=0, **extra):
    from satpu.models.asrbn import Wav2Vec2TDNNFNet as JNet
    from satpu.models.asrbn import wav2vec2_tdnnf_config as jcfg
    from satpu.models.wav2vec2 import Wav2Vec2Config as JW
    from satpu_torch.models.asrbn import Wav2Vec2TDNNFNet, wav2vec2_tdnnf_config
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.models.wav2vec2 import Wav2Vec2Config

    kw = dict(NET, codebook_size=8, epsilon=2.0, **extra)
    jnet = JNet(dataclasses.replace(jcfg(P, bottleneck), **kw), JW(**w2v))
    wav = np.zeros((1, 16000), np.float32)
    variables = randomize_bn(jax_variables_numpy(jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                                                     wav)), seed)
    net = Wav2Vec2TDNNFNet(dataclasses.replace(wav2vec2_tdnnf_config(P, bottleneck), **kw),
                           Wav2Vec2Config(**w2v))
    sd = from_satpu_variables(variables)
    assert set(sd) == set(net.state_dict()), set(sd) ^ set(net.state_dict())
    net.load_state_dict(sd)
    return jnet, variables, net.eval()


def test_wav2vec2_tdnnf_forward_and_extract_bn_match_satpu():
    jnet, variables, net = _w2v_nets()
    wav = (np.random.default_rng(1).standard_normal((2, 24000)) * 0.1).astype(np.float32)
    chain, xent = jax.jit(lambda v, w: jnet.apply(v, w))(variables, wav)
    bn = jax.jit(lambda v, w: jnet.apply(v, w, method=jnet.extract_bn))(variables, wav)
    with torch.no_grad():
        pc, px = net(torch.from_numpy(wav))
        pbn = net.extract_bn(torch.from_numpy(wav))
    assert pc.shape == chain.shape and pbn.shape == bn.shape
    assert rel_err(pc.numpy(), chain) <= 1e-4
    assert rel_err(px.numpy(), xent) <= 1e-4
    assert rel_err(pbn.numpy(), bn) <= 1e-4
    # the VQ picks the same codes (the bottleneck is a codebook row)
    code = net.tdnnfs[-1].tdnn.bottleneck_func.vq.embedding.numpy()

    def idx(x):
        return np.argmin(((np.asarray(x)[..., None, :] - code) ** 2).sum(-1), -1)

    np.testing.assert_array_equal(idx(pbn.numpy()), idx(bn))


@pytest.fixture(scope="module")
def real_geometry():
    """Nets with the real 7-conv front (wav2vec2 large's kernels and strides)
    at 8 channels."""
    return _w2v_nets(dict(W2V, conv_dim=(8,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                          conv_stride=(5, 2, 2, 2, 2, 2, 2), num_conv_pos_embeddings=16),
                     bottleneck="none")


def test_wav2vec2_tdnnf_output_frames_sweep(real_geometry):
    from satpu_torch.chain.prep import allowed_sample_lengths
    from satpu_torch.models.asrbn import wav2vec2_output_num_frames

    jnet, variables, net = real_geometry
    cfg, w2v = net.cfg, net.w2v2
    egs = lambda n: max(((n + 80) // 160 - 2) // 3, 0)  # EgsDataset.output_frames
    allowed = allowed_sample_lengths(list(range(20000, 64000, 1000)))
    for n in [8000, 12345, 16000, 24000, 33333, 47520, 48000, 48480] + allowed[:3]:
        wav = np.zeros((1, n), np.float32)
        t_sat = jax.eval_shape(lambda v, w: jnet.apply(v, w), variables, wav)[0].shape[1]
        with torch.no_grad():
            t_port = net(torch.zeros(1, n))[0].shape[1]
        assert t_port == t_sat == wav2vec2_output_num_frames(n, cfg, w2v), n
    diffs = {wav2vec2_output_num_frames(n, cfg, w2v) - egs(n) for n in range(8000, 160000, 7)}
    assert diffs == {0, 1}
    assert {wav2vec2_output_num_frames(n, cfg, w2v) - egs(n) for n in allowed} <= {0, 1}
    assert wav2vec2_output_num_frames(48000, cfg, w2v) == egs(48000) == 99


def test_rev_grad():
    from satpu_torch.models.tdnnf import rev_grad

    x = torch.randn(3, 4, dtype=torch.float64, requires_grad=True)
    g = torch.randn(3, 4, dtype=torch.float64)
    y = rev_grad(x, 0.7)
    assert torch.equal(y, x)
    y.backward(g)
    assert torch.equal(x.grad, -0.7 * g)


def test_dp_noise_matches_satpu_on_the_same_draw():
    from satpu.models.asrbn import DpLaplaceBottleneck as JDp
    from satpu_torch.models.asrbn import laplace_noise

    eps = 2.0
    x = np.random.default_rng(3).standard_normal((2, 50, 16)).astype(np.float32)
    m = JDp(eps)
    y = np.asarray(m.apply({}, jnp.asarray(x), rngs={"noise": jax.random.PRNGKey(5)}))
    d = (y - x).astype(np.float64)
    # invert d = -b sign(u) log1p(-2|u|): sign(u) = sign(d), |u| = (1 - exp(-|d| / b)) / 2
    u = np.sign(d) * (1 - np.exp(-np.abs(d) * eps)) / 2
    assert np.all(np.abs(u) < 0.5)
    got = laplace_noise(torch.from_numpy(x).double(), torch.from_numpy(u), eps).numpy()
    assert rel_err(got, y) <= 1e-6


def test_dp_noise_follows_the_laplace_law():
    from satpu_torch.models.asrbn import DpLaplaceBottleneck

    eps = 2.0
    dp = DpLaplaceBottleneck(eps)
    dp.generator = torch.Generator().manual_seed(0)
    noise = dp(torch.zeros(100_000, dtype=torch.float64)).numpy()
    b = 1.0 / eps
    xs = np.sort(noise)
    cdf = np.where(xs < 0, 0.5 * np.exp(xs / b), 1 - 0.5 * np.exp(-xs / b))
    ks = np.max(np.abs(cdf - (np.arange(1, len(xs) + 1) - 0.5) / len(xs)))
    assert ks <= 0.01, ks
    assert abs(np.abs(noise).mean() - b) <= 0.02 * b
    # the generator decides the draw
    dp.generator = torch.Generator().manual_seed(0)
    assert np.array_equal(dp(torch.zeros(100_000, dtype=torch.float64)).numpy(), noise)


def _x64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64)
                                  if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def test_tdnnf_bn_tap_and_spkadv_match_satpu_in_training():
    from satpu.models.asrbn import TDNNFNetConfig as JCfg
    from satpu.models.spkadv import SpkAdvTDNNFNet as JNet
    from satpu_torch.models.asrbn import TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.models.spkadv import SpkAdvTDNNFNet

    cfg = dict(NET, output_dim=P, p_dropout=0.0)
    jnet = JNet(JCfg(**cfg), num_speakers=4)
    wav = (np.random.default_rng(4).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    target = np.array([0, 3, 1], np.int32)
    variables = randomize_bn(jax_variables_numpy(jax.jit(jnet.init)(
        jax.random.PRNGKey(0), wav[:2])), 1)
    net = SpkAdvTDNNFNet(TDNNFNetConfig(**cfg), num_speakers=4)
    sd = from_satpu_variables(variables)
    assert set(sd) == set(net.state_dict()), set(sd) ^ set(net.state_dict())
    net.load_state_dict(sd)
    net.double().train()
    mutable = ["batch_stats", "aux_loss", "aux_metric"]
    with jax.enable_x64():
        v64 = _x64(variables)
        (chain, xent), new = jnet.apply(v64, wav.astype(np.float64), train=True,
                                        spk_target=jnp.asarray(target), mutable=mutable)
        (_, _, bn), _ = jnet.apply(v64, wav.astype(np.float64), train=True, mutable=mutable,
                                   method=lambda m, w, train: m.acoustic(w, train=train,
                                                                         return_bn=True))

        def adv(v):  # the adversarial loss's gradient w.r.t. the bottleneck
            def loss_of(b):
                from satpu.models.tdnnf import rev_grad as jrev
                return jnet.apply(v, jrev(b, 1.0), train=True, target=jnp.asarray(target),
                                  mutable=mutable, method=jnet.speaker_logits)[0][0]
            return jax.grad(loss_of)(bn)

        dbn = np.asarray(adv(v64))
    pc, px, aux = net(torch.from_numpy(wav).double(), spk_target=torch.from_numpy(target).long())
    assert rel_err(pc.detach().numpy(), chain) <= 1e-4
    assert rel_err(px.detach().numpy(), xent) <= 1e-4
    leaves = {str(p[-2].key): float(np.sum(v)) for p, v in jax.tree_util.tree_flatten_with_path(
        {**new["aux_loss"], **new["aux_metric"]})[0]}
    assert rel_err(aux["spkadv_loss"].item(), leaves["spkadv_loss"]) <= 1e-4
    assert aux["spkadv_accuracy"].item() == leaves["spkadv_accuracy"]
    # the BN tap and the reversed gradient into it
    _, _, _, pbn = net.acoustic(torch.from_numpy(wav).double(), return_bn=True)
    assert rel_err(pbn.detach().transpose(1, 2).numpy(), bn) <= 1e-4
    # the branch on satpu's own tap; satpu's batch norms compute in f32 even
    # under x64, and the train-mode half-ResNet's gradients are held at 1e-2
    # as in tests/test_torch_asv_trainer.py (ROADMAP "Recorded, not port
    # faults")
    tap = torch.from_numpy(np.asarray(bn)).transpose(1, 2).contiguous().requires_grad_(True)
    from satpu_torch.models.tdnnf import rev_grad

    loss, _ = net.speaker_logits(rev_grad(tap, 1.0), torch.from_numpy(target).long())
    loss.backward()
    assert rel_err(tap.grad.transpose(1, 2).numpy(), dbn) <= 1e-2
    # adversarial off: the same loss, the gradient's sign flipped
    tap2 = tap.detach().clone().requires_grad_(True)
    net.speaker_logits(tap2, torch.from_numpy(target).long())[0].backward()
    assert torch.allclose(tap2.grad, -tap.grad)


@pytest.mark.parametrize("model_id", ["asrbn_tdnnf_wav2vec2", "asrbn_tdnnf_spkadv"])
def test_variant_checkpoints_round_trip(model_id, tmp_path):
    from satpu_torch import infer_helper

    if model_id == "asrbn_tdnnf_wav2vec2":
        params = dict(NET, output_dim=P, bottleneck="dp", epsilon=1.0, kernel_size_list=[3, 3, 3],
                      subsampling_factor_list=[1, 1, 1], wav2vec2=dict(W2V))
    else:
        params = dict(NET, output_dim=P, num_speakers=5, adversarial=False)
    model = infer_helper.build_model(model_id, device="cpu", seed=3, **params)
    path = str(tmp_path / "m.ckpt")
    infer_helper.save_model(path, model_id, params, model.state_dict())
    loaded, meta = infer_helper.load_model(path, device="cpu")
    assert meta["model_id"] == model_id and type(loaded) is type(model)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    wav = torch.zeros(1, 16000)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        bn = loaded.eval().extract_bn(wav, generator=g)
    assert bn.shape[-1] == NET["prefinal_bottleneck_dim"] and torch.isfinite(bn).all()
    if model_id == "asrbn_tdnnf_spkadv":
        assert (loaded.asi_margin.weight.shape[0], loaded.adversarial) == (5, False)
