"""The port's GAN modules against satpu's on the same weights and inputs
(f32, TF32 off): SNConv's power iteration, its new (u, v) and the gradient
through it; WNConv2d; the period and scale discriminators; MPD / MSD scores
and every feature map; the three losses; the log-mel spectrogram; and the
explicit zero pad of the CPU's 2-D convs, with the crash it avoids.

satpu's modules run NHWC with time on H; the port's run NCHW with time on H,
so feature maps are compared after a transpose."""
import numpy as np
import pytest
import torch

from torch_parity import harmonic, rel_err

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the tier-1 run shares the host's cores among its
    workers, and oversubscribed CPU convs slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _to_nchw(x):
    """satpu NHWC feature map -> NCHW."""
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _port(module, variables):
    from satpu_torch.models.convert import from_satpu_discriminators

    sd = from_satpu_discriminators(variables)
    assert set(sd) == set(module.state_dict()), set(sd) ^ set(module.state_dict())
    module.load_state_dict(sd)
    return module


def _audio(B, T, seed):
    return (np.random.default_rng(seed).standard_normal((B, T)) * 0.3).astype(np.float32)


def test_snconv_power_iteration_and_its_gradient():
    import jax
    import jax.numpy as jnp

    from satpu.models.hifigan import SNConv as JSN
    from satpu_torch.models.hifigan import SNConv

    # a grouped 41-tap conv (the MSD's second layer, narrowed)
    cin, cout, k, s, p, g = 16, 32, 41, 2, 20, 4
    x = np.random.default_rng(0).standard_normal((2, 100, 1, cin)).astype(np.float32)
    jm = JSN(cin, cout, (k, 1), (s, 1), (p, 0), groups=g)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    r = np.random.default_rng(1).standard_normal((2, 50, 1, cout)).astype(np.float32)

    def jloss(params):
        y, new = jm.apply({"params": params, "spectral": v["spectral"]}, x, update_sn=True,
                          mutable=["spectral"])
        return jnp.sum(y * r), (y, new["spectral"])

    (_, (jy, jspec)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])

    m = _port(SNConv(cin, cout, (k, 1), (s, 1), (p, 0), groups=g), v)
    uv = m.power_iteration()
    y = m(torch.from_numpy(x).permute(0, 3, 1, 2), uv)
    (y * torch.from_numpy(_to_nchw(r))).sum().backward()
    assert rel_err(y.detach().numpy(), _to_nchw(jy)) <= 1e-5
    assert rel_err(uv[0].detach().numpy(), jspec["u"]) <= 1e-5
    assert rel_err(uv[1].detach().numpy(), jspec["v"]) <= 1e-5
    assert rel_err(m.weight_orig.grad.numpy(), jgrad["weight_orig"]) <= 1e-4
    assert rel_err(m.bias.grad.numpy(), jgrad["bias"]) <= 1e-4
    # without an update the stored (u, v) are constants
    y0, _ = jm.apply(v, x, update_sn=False, mutable=["spectral"])
    assert rel_err(m(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy(),
                   _to_nchw(y0)) <= 1e-5


def test_snconv_own_init_follows_satpus_scheme():
    from satpu_torch.models.hifigan import SNConv, WNConv2d

    a, b = SNConv(4, 8, (5, 1), (1, 1), (2, 0)), SNConv(4, 8, (5, 1), (1, 1), (2, 0))
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(1))
    # u, v: fixed draws whatever the seed; the weight seeded, the bias zero
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
    assert not torch.equal(a.weight_orig, b.weight_orig)
    assert float(a.bias.detach().abs().max()) == 0.0
    w = WNConv2d(4, 8, (5, 1), (1, 1), (2, 0))
    # g is the norm of a second draw, not of v
    assert not torch.allclose(w.weight_g.flatten(), w.weight_v.flatten(1).norm(dim=1))
    assert float(w.bias.detach().abs().max()) == 0.0


def test_wnconv2d_grouped():
    import jax

    from satpu.models.hifigan import WNConv2d as JWN
    from satpu_torch.models.hifigan import WNConv2d

    x = np.random.default_rng(2).standard_normal((2, 90, 3, 16)).astype(np.float32)
    jm = JWN(16, 32, (41, 1), (4, 1), (20, 0), groups=16)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), x))
    m = _port(WNConv2d(16, 32, (41, 1), (4, 1), (20, 0), groups=16), v)
    y = m(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    assert rel_err(y, _to_nchw(jm.apply(v, x))) <= 1e-4


def _check_disc(out, ref):
    (score, fmap), (jscore, jfmap) = out, ref
    assert rel_err(score.detach().numpy(), jscore) <= 1e-4
    assert len(fmap) == len(jfmap)
    for a, b in zip(fmap, jfmap):
        assert a.dtype == torch.float32
        assert rel_err(a.detach().numpy(), _to_nchw(b)) <= 1e-4


@pytest.mark.parametrize("period", [3, 5])
def test_discriminator_p_reflect_pad(period):
    import jax

    from satpu.models.hifigan import DiscriminatorP as JP
    from satpu_torch.models.hifigan import DiscriminatorP

    y = _audio(2, 1001, seed=period)  # 1001 % 3 and % 5 != 0: the reflect pad
    jm = JP(period, channel_scale=1 / 8)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(period), y[:, :, None]))
    m = _port(DiscriminatorP(period, channel_scale=1 / 8), v)
    _check_disc(m(torch.from_numpy(y)[:, None]), jm.apply(v, y[:, :, None]))


@pytest.mark.parametrize("sn", [False, True], ids=["weight_norm", "spectral_norm"])
def test_discriminator_s_grouped_full_width(sn):
    import jax

    from satpu.models.hifigan import DiscriminatorS as JS
    from satpu_torch.models.hifigan import DiscriminatorS

    y = _audio(2, 512, seed=3)
    jm = JS(use_spectral_norm=sn)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(4), y[:, :, None]))
    m = _port(DiscriminatorS(use_spectral_norm=sn), v)
    assert [c.groups for c in m.convs] == [1, 4, 16, 16, 16, 16, 1]
    ref = jm.apply(v, y[:, :, None], mutable=["spectral"])[0] if sn else jm.apply(v, y[:, :, None])
    _check_disc(m(torch.from_numpy(y)[:, None]), ref)


def _tiny_discs(T, seed=0):
    import jax

    from satpu.models.hifigan import MultiPeriodDiscriminator as JMPD
    from satpu.models.hifigan import MultiScaleDiscriminator as JMSD
    from satpu_torch.models.hifigan import MultiPeriodDiscriminator, MultiScaleDiscriminator

    dummy = np.zeros((1, T, 1), np.float32)
    jmpd = JMPD(periods=(2, 3), channel_scale=1 / 16)
    jmsd = JMSD(num_scales=2, channel_scale=1 / 16)
    vmpd = _np(jax.jit(jmpd.init)(jax.random.PRNGKey(seed), dummy, dummy))
    vmsd = _np(jax.jit(jmsd.init)(jax.random.PRNGKey(seed + 1), dummy, dummy))
    mpd = _port(MultiPeriodDiscriminator(periods=(2, 3), channel_scale=1 / 16), vmpd)
    msd = _port(MultiScaleDiscriminator(num_scales=2, channel_scale=1 / 16), vmsd)
    return (jmpd, vmpd, mpd), (jmsd, vmsd, msd)


def test_mpd_msd_scores_fmaps_and_sn_state():
    (jmpd, vmpd, mpd), (jmsd, vmsd, msd) = _tiny_discs(800)
    y, yg = _audio(2, 800, seed=5), _audio(2, 800, seed=6)
    ty, tyg = torch.from_numpy(y)[:, None], torch.from_numpy(yg)[:, None]
    jy, jyg = y[:, :, None], yg[:, :, None]

    ref = jmpd.apply(vmpd, jy, jyg)
    out = mpd(ty, tyg)
    ref_s, new = jmsd.apply(vmsd, jy, jyg, update_sn=True, mutable=["spectral"])
    out_s = msd(ty, tyg, update_sn=True)
    for o, r in ((out, ref), (out_s, ref_s)):
        for k in range(len(r[0])):  # real and generated, every discriminator
            _check_disc((o[0][k], o[2][k]), (r[0][k], r[2][k]))
            _check_disc((o[1][k], o[3][k]), (r[1][k], r[3][k]))
    # the buffers now hold the updated (u, v)
    from satpu_torch.models.convert import from_satpu_discriminators

    want = from_satpu_discriminators({"spectral": new["spectral"]})
    state = msd.state_dict()
    for key, val in want.items():
        assert rel_err(state[key].numpy(), val.numpy()) <= 1e-5, key
        assert not state[key].requires_grad


def test_losses():
    import jax.numpy as jnp

    from satpu.models import hifigan as J
    from satpu_torch.models import hifigan as P

    r = np.random.default_rng(7)
    real = [r.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 13)]
    gen = [r.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 13)]
    fr = [[r.standard_normal((2, 3, n, 2)).astype(np.float32) for n in (4, 6)] for _ in range(3)]
    fg = [[r.standard_normal((2, 3, n, 2)).astype(np.float32) for n in (4, 6)] for _ in range(3)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    j = lambda xs: [jnp.asarray(x) for x in xs]
    assert rel_err(P.feature_loss([t(a) for a in fr], [t(a) for a in fg]),
                   J.feature_loss([j(a) for a in fr], [j(a) for a in fg])) <= 1e-6
    (pl, pr, pg), (jl, jr, jg) = (P.discriminator_loss(t(real), t(gen)),
                                  J.discriminator_loss(j(real), j(gen)))
    assert rel_err(pl, jl) <= 1e-6
    assert all(rel_err(a, b) <= 1e-6 for a, b in zip(pr + pg, jr + jg))
    (pl, pls), (jl, jls) = P.generator_loss(t(gen)), J.generator_loss(j(gen))
    assert rel_err(pl, jl) <= 1e-6 and all(rel_err(a, b) <= 1e-6 for a, b in zip(pls, jls))


@pytest.mark.parametrize("signal", ["noise", "harmonic"])
@pytest.mark.parametrize("geometry", [dict(), dict(n_fft=64, num_mels=8, hop_size=16,
                                                   win_size=48)],
                         ids=["hifigan", "tiny_short_window"])
def test_mel_spectrogram(signal, geometry):
    from satpu.ops.mel import mel_spectrogram as jmel
    from satpu_torch.ops.mel import mel_spectrogram

    if signal == "noise":
        y = _audio(2, 8000, seed=8) * 0.3
    else:
        y = np.stack([harmonic(8000, f, seed=i)[0] for i, f in enumerate((120.0, 210.0))])
    ref = np.asarray(jmel(y, **geometry))
    out = mel_spectrogram(torch.from_numpy(y), **geometry).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-3


# PyTorch 2.13.0's CPU (oneDNN) conv2d backward with padding corrupts the
# heap at this shape (a 41-tap kernel, padding 20, over 13 frames): the
# process dies with `malloc(): corrupted top size` or a segfault.
_CRASHING_CONV = ("import torch, torch.nn.functional as F\n"
                  "x = torch.randn(2, 64, 13, 1, requires_grad=True)\n"
                  "w = torch.randn(64, 64, 41, 1, requires_grad=True)\n"
                  "F.conv2d(x, w, None, padding=(20, 0)).sum().backward()\n")


def test_cpu_conv2d_backward_with_padding_crashes():
    """Why ``models.hifigan._conv2d`` pads explicitly on the CPU. Should this
    fail, the installed torch no longer crashes (found on 2.13.0; re-check at
    each upgrade): drop that branch and keep F.conv2d's own padding."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", _CRASHING_CONV], capture_output=True,
                          timeout=120)
    assert proc.returncode < 0, (
        f"torch {torch.__version__}: the padded conv2d backward ran (rc {proc.returncode})")


@pytest.mark.parametrize("cin, cout, T, k, stride, pad, groups", [
    (64, 64, 13, 41, 1, 20, 1),  # the crashing shape (the MSD's 41-tap layers, narrowed)
    (16, 64, 26, 41, 4, 20, 4),  # grouped and strided
    (4, 8, 137, 5, 3, 2, 1),  # the MPD's (5, 1) layers
])
def test_conv2d_explicit_cpu_pad_matches_padded_conv(cin, cout, T, k, stride, pad, groups):
    """``_conv2d``'s explicit zero pad gives F.conv2d's padded output and
    gradients (against F.conv2d in f64, which oneDNN does not take)."""
    import torch.nn.functional as F

    from satpu_torch.models.hifigan import _conv2d

    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, cin, T, 2))
    w = rng.standard_normal((cout, cin // groups, k, 1)) / np.sqrt(cin // groups * k)
    b = rng.standard_normal(cout)
    out = {}
    for dt in (torch.float32, torch.float64):
        xs, ws, bs = (torch.tensor(a, dtype=dt, requires_grad=True) for a in (x, w, b))
        if dt == torch.float32:
            y = _conv2d(xs, ws, bs, (stride, 1), (pad, 0), groups)
        else:
            y = F.conv2d(xs, ws, bs, stride=(stride, 1), padding=(pad, 0), groups=groups)
        (y * torch.linspace(-1, 1, y.numel(), dtype=dt).reshape(y.shape)).sum().backward()
        out[dt] = [t.detach().numpy() for t in (y, xs.grad, ws.grad, bs.grad)]
    for got, want in zip(out[torch.float32], out[torch.float64]):
        assert got.shape == want.shape and rel_err(got, want) <= 1e-5
