"""satpu_torch's ASV modules against satpu's on the CPU at f32: frontends
(max abs 1e-3), each block of sidekit/nn.py, the pooling layers, the
ECAPA and half-ResNet trunks and ArcMargin (rel 1e-4 on the same input
features), and the whole x-vector models from wav (max abs 1e-3, cosine
>= 0.9999). satpu's weights are carried across with the weight bridge,
with randomized batch-norm statistics and affines."""
import numpy as np
import pytest
import torch

from torch_parity import XV_TINY, bridged, rel_err, satpu_apply, satpu_init, satpu_xvector


def _signals(B, T, seed):
    """Noise at 0.1 amplitude plus a harmonic: energy in every frame."""
    r = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    tone = 0.2 * np.sin(2 * np.pi * (120 + 40 * np.arange(B))[:, None] * t)
    return (r.standard_normal((B, T)) * 0.1 + tone).astype(np.float32)


@pytest.mark.parametrize("name", ["melspec", "mfcc"])
def test_frontend_matches_satpu(name):
    """mel_spec_frontend / mfcc_frontend: max abs 1e-3 after InstanceNorm."""
    from satpu.sidekit import preprocessor as J
    from satpu_torch.sidekit import preprocessor as P

    x = _signals(2, 16000, seed=1)
    fn_j, fn_p, kw = {"melspec": (J.mel_spec_frontend, P.mel_spec_frontend, {"n_mels": 24}),
                      "mfcc": (J.mfcc_frontend, P.mfcc_frontend, {"n_mfcc": 24})}[name]
    ref = np.asarray(fn_j(x, **kw))  # [B, T, F]
    out = fn_p(torch.from_numpy(x), **kw).numpy()  # [B, F, T]
    assert out.shape == ref.transpose(0, 2, 1).shape
    err = np.abs(out - ref.transpose(0, 2, 1)).max()
    assert err <= 1e-3, err


def test_pre_emphasis_reflects_x1():
    """the sample before x[0] is x[1], exactly as satpu's."""
    from satpu.sidekit.preprocessor import pre_emphasis as jpre
    from satpu_torch.sidekit.preprocessor import pre_emphasis

    x = _signals(2, 50, seed=2)
    np.testing.assert_allclose(pre_emphasis(torch.from_numpy(x)).numpy(),
                               np.asarray(jpre(x)), rtol=0, atol=1e-7)


def _blocks():
    """(id, satpu module, port module, input layout, input shape)."""
    from satpu.sidekit import nn as J
    from satpu_torch.sidekit import nn as P

    return {
        "SELayer": (J.SELayer(32), P.SELayer(32), "2d", (2, 6, 5, 32)),
        "ResNetBasicBlock-stride2": (J.ResNetBasicBlock(8, 16, (2, 2)),
                                     P.ResNetBasicBlock(8, 16, (2, 2)), "2d", (2, 12, 10, 8)),
        "ResNetBasicBlock-identity": (J.ResNetBasicBlock(16, 16, (1, 1)),
                                      P.ResNetBasicBlock(16, 16, (1, 1)), "2d", (2, 6, 5, 16)),
        "Conv1dReluBn": (J.Conv1dReluBn(12, 16, 5, padding=2), P.Conv1dReluBn(12, 16, 5, padding=2),
                         "1d", (2, 15, 12)),
        "Res2Conv1dReluBn": (J.Res2Conv1dReluBn(32, 3, 1, 2, 2, 8),
                             P.Res2Conv1dReluBn(32, 3, 1, 2, 2, 8), "1d", (2, 15, 32)),
        "SEConnect": (J.SEConnect(16), P.SEConnect(16), "1d", (2, 15, 16)),
        "SERes2Block": (J.SERes2Block(32, 3, 1, 3, 3, 8), P.SERes2Block(32, 3, 1, 3, 3, 8),
                        "1d", (2, 15, 32)),
    }


def _to_port_layout(x, layout):
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2) if layout == "2d" else x.transpose(0, 2, 1))


@pytest.mark.parametrize("name", ["SELayer", "ResNetBasicBlock-stride2",
                                  "ResNetBasicBlock-identity", "Conv1dReluBn",
                                  "Res2Conv1dReluBn", "SEConnect", "SERes2Block"])
def test_block_matches_satpu(name):
    """each block of sidekit/nn.py: rel 1e-4 (channels-last in satpu,
    channels-first in the port)."""
    jm, pm, layout, shape = _blocks()[name]
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    train_kw = {} if name in ("SELayer", "SEConnect") else {"train": False}
    v = satpu_init(jm, x, **train_kw)
    ref = np.asarray(satpu_apply(jm, v, x, **train_kw))
    with torch.no_grad():
        out = bridged(pm, v)(torch.from_numpy(_to_port_layout(x, layout))).numpy()
    ref = _to_port_layout(ref, layout)
    assert out.shape == ref.shape
    assert rel_err(out, ref) <= 1e-4, rel_err(out, ref)


@pytest.mark.parametrize("name", ["MeanStdPooling-1d", "MeanStdPooling-resnet",
                                  "AttentiveStatsPool", "AttentivePooling",
                                  "AttentivePooling-global"])
def test_pooling_matches_satpu(name):
    """pooling layers: rel 1e-4; ResNet maps [B, C, F, T] flatten as C*F."""
    from satpu.sidekit import pooling as J
    from satpu_torch.sidekit import pooling as P

    jm, pm, shape = {
        "MeanStdPooling-1d": (J.MeanStdPooling(), P.MeanStdPooling(), (2, 17, 12)),
        "MeanStdPooling-resnet": (J.MeanStdPooling(), P.MeanStdPooling(), (2, 3, 17, 8)),
        "AttentiveStatsPool": (J.AttentiveStatsPool(24, 8), P.AttentiveStatsPool(24, 8),
                               (2, 17, 24)),
        "AttentivePooling": (J.AttentivePooling(8, 3), P.AttentivePooling(8, 3), (2, 3, 17, 8)),
        "AttentivePooling-global": (J.AttentivePooling(8, 3, global_context=True),
                                    P.AttentivePooling(8, 3, global_context=True),
                                    (2, 3, 17, 8)),
    }[name]
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    kw = {"train": False} if name.startswith("AttentivePooling") else {}
    v = satpu_init(jm, x, **kw)
    ref = np.asarray(satpu_apply(jm, v, x, **kw))
    # satpu: [B, T, C] or [B, F, T, C]; the port: [B, C, T] or [B, C, F, T]
    xp = x.transpose(0, 2, 1) if x.ndim == 3 else x.transpose(0, 3, 1, 2)
    with torch.no_grad():
        out = bridged(pm, v)(torch.from_numpy(np.ascontiguousarray(xp))).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) <= 1e-4, rel_err(out, ref)


@pytest.mark.parametrize("name", ["PreEcapaTDNN", "PreHalfResNet34"])
def test_trunk_matches_satpu(name):
    """the trunks on the same mel features [B, T, 24]: rel 1e-4 (the
    half-ResNet at depth (1, 2, 1, 1); its full depth runs in the x-vector
    test below)."""
    from satpu.sidekit import archi as J
    from satpu_torch.sidekit import archi as P

    jm, pm = {"PreEcapaTDNN": (J.PreEcapaTDNN(24, 32), P.PreEcapaTDNN(24, 32)),
              "PreHalfResNet34": (J.PreHalfResNet34((1, 2, 1, 1)),
                                  P.PreHalfResNet34((1, 2, 1, 1)))}[name]
    x = np.random.default_rng(5).standard_normal((2, 20, 24)).astype(np.float32)
    v = satpu_init(jm, x, train=False)
    ref = np.asarray(satpu_apply(jm, v, x, train=False))
    with torch.no_grad():
        out = bridged(pm, v)(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))).numpy()
    # satpu: ECAPA [B, T, C], ResNet NHWC [B, F, T, C]
    ref = ref.transpose(0, 2, 1) if ref.ndim == 3 else ref.transpose(0, 3, 1, 2)
    assert out.shape == ref.shape
    assert rel_err(out, ref) <= 1e-4, rel_err(out, ref)


@pytest.mark.parametrize("with_target", [False, True])
def test_arcmargin_matches_satpu(with_target):
    """ArcMargin logits rel 1e-4 with and without a target; the loss
    likewise with one, NaN without."""
    from satpu.sidekit.loss import ArcMarginProduct as J
    from satpu_torch.sidekit.loss import ArcMarginProduct as P

    r = np.random.default_rng(6)
    x = r.standard_normal((6, 16)).astype(np.float32)
    tgt = r.integers(0, 10, 6) if with_target else None
    jm = J(16, 10, s=30, m=0.2)
    v = satpu_init(jm, x, tgt)
    ref_loss, ref_logits = jm.apply(v, x, tgt)
    with torch.no_grad():
        loss, logits = bridged(P(16, 10, s=30, m=0.2), v)(
            torch.from_numpy(x), None if tgt is None else torch.from_numpy(tgt))
    assert rel_err(logits.numpy(), ref_logits) <= 1e-4
    if with_target:
        assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    else:
        assert np.isnan(loss.item()) and np.isnan(float(ref_loss))


@pytest.mark.parametrize("arch,frontend", [("ecapa", "melspec"), ("ecapa", "mfcc"),
                                           ("resnet", "melspec")])
def test_xvector_from_wav_matches_satpu(arch, frontend):
    """EcapaXVector / ResNetXVector from wav: x-vectors max abs 1e-3 and
    cosine with satpu's >= 0.9999; logits rel 1e-3."""
    jm, v, pm = satpu_xvector(arch=arch, frontend=frontend, **XV_TINY)
    wav = _signals(3, 12000, seed=7)
    (_, ref_logits), ref = satpu_apply(jm, v, wav, train=False)
    ref = np.asarray(ref)
    with torch.no_grad():
        (_, logits), out = pm(torch.from_numpy(wav))
    out = out.numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-3, np.abs(out - ref).max()
    cos = (out * ref).sum(1) / np.linalg.norm(out, axis=1) / np.linalg.norm(ref, axis=1)
    assert cos.min() >= 0.9999, cos
    assert rel_err(logits.numpy(), ref_logits) <= 1e-3
