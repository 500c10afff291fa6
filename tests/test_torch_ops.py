"""satpu_torch ops against satpu on the CPU: fbank, the two CMVNs,
interpolate_nearest and the F0 transforms."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.mark.parametrize("T,snip_edges", [(16000, False), (12345, False), (12345, True)])
def test_fbank_matches_satpu(T, snip_edges):
    """log-mel of the BN front end (80 bins, dither 0); torch.fft in place of
    satpu's DFT matmuls: max abs <= 1e-3."""
    from satpu.ops.fbank import fbank as jfbank
    from satpu_torch.ops.fbank import fbank

    x = np.random.default_rng(T).standard_normal((2, T)).astype(np.float32) * 3000.0
    ref = np.asarray(jfbank(jnp.asarray(x), num_mel_bins=80, snip_edges=snip_edges))
    out = fbank(torch.from_numpy(x), num_mel_bins=80, snip_edges=snip_edges).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-3, np.abs(out - ref).max()


def test_fbank_mel_banks_are_satpu_banks():
    from satpu.ops.fbank import mel_banks as jbanks
    from satpu_torch.ops.fbank import mel_banks

    for args in [(80, 512, 16000.0), (23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, 0.9)]:
        np.testing.assert_array_equal(mel_banks(*args), jbanks(*args))


@pytest.mark.parametrize("var_norm", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_utt_cmvn_matches_satpu(var_norm, masked):
    from satpu.ops.cmvn import utt_cmvn as jcmvn
    from satpu_torch.ops.cmvn import utt_cmvn

    x = np.random.default_rng(0).standard_normal((3, 40, 5)).astype(np.float32) * 4 + 2
    lengths = np.array([40, 17, 3], np.int32) if masked else None
    ref = np.asarray(jcmvn(jnp.asarray(x), var_norm=var_norm,
                           lengths=None if lengths is None else jnp.asarray(lengths)))
    out = utt_cmvn(torch.from_numpy(x), var_norm=var_norm,
                   lengths=None if lengths is None else torch.from_numpy(lengths)).numpy()
    assert np.abs(out - ref).max() <= 1e-5


def test_utt_cmvn_keep_zeros_matches_satpu():
    from satpu.ops.cmvn import utt_cmvn_keep_zeros as jkz
    from satpu_torch.ops.cmvn import utt_cmvn_keep_zeros

    rng = np.random.default_rng(1)
    f0 = (rng.random((3, 60)) * 200 + 80).astype(np.float32)
    f0[rng.random(f0.shape) < 0.3] = 0.0
    f0[2] = 0.0  # an all-unvoiced utterance stays zero
    ref = np.asarray(jkz(jnp.asarray(f0)))
    out = utt_cmvn_keep_zeros(torch.from_numpy(f0)).numpy()
    assert np.abs(out - ref).max() <= 1e-5
    np.testing.assert_array_equal(out == 0, f0 == 0)


@pytest.mark.parametrize("in_len,out_len", [(50, 25), (51, 26), (500, 251), (799, 400),
                                            (26, 13), (1001, 500)])
def test_interpolate_nearest_index_equality(in_len, out_len):
    """The source frame of every output frame equals satpu's (f32 index
    arithmetic); a shifted index would misalign F0 and BN by a frame."""
    from satpu.models.anonymizer import interpolate_nearest as jinterp
    from satpu_torch.models.anonymizer import interpolate_nearest

    x = np.arange(in_len, dtype=np.float32)[None, None, :]
    ref = np.asarray(jinterp(jnp.asarray(x), out_len))
    out = interpolate_nearest(torch.from_numpy(x), out_len).numpy()
    np.testing.assert_array_equal(out, ref)


def _f0_track():
    rng = np.random.default_rng(2)
    f0 = rng.standard_normal((2, 1, 80)).astype(np.float32)
    f0[..., :10] = 0.0
    return f0


@pytest.mark.parametrize("spec", ["quant_16", "mean-reverv_0.5:32", "quant_8_mean-reverv_0.3:8"])
def test_deterministic_f0_transforms_match_satpu(spec):
    from satpu.models.hifigan import apply_f0_transformation as japply
    from satpu_torch.models.hifigan import apply_f0_transformation

    f0 = _f0_track()
    ref = np.asarray(japply(jnp.asarray(f0), spec))
    out = apply_f0_transformation(torch.from_numpy(f0), spec).numpy()
    assert np.abs(out - ref).max() <= 1e-6


def test_f0_transformation_spec_parse_matches_satpu():
    from satpu.models.hifigan import parse_f0_transformation_spec as jparse
    from satpu_torch.models.hifigan import parse_f0_transformation_spec

    for spec in ["", "quant_16", "awgn_2", "quant_16_awgn_2", "mean-reverv_0.5:32"]:
        assert parse_f0_transformation_spec(spec) == jparse(spec)


def test_awgn_f0_statistics():
    """awgn draws from a torch.Generator, so hold its distribution: zero-mean
    noise of power 10**(db/10) on voiced frames only, reproducible by seed."""
    from satpu_torch.models.hifigan import awgn_f0

    f0 = torch.full((4, 5000), 100.0)
    f0[:, :1000] = 0.0
    out = awgn_f0(f0, torch.Generator().manual_seed(0), target_noise_db=10.0)
    noise = (out - f0)[:, 1000:]
    assert torch.all(out[:, :1000] == 0)
    assert abs(noise.mean().item()) < 0.1
    assert abs(noise.var().item() - 10.0) < 0.5
    again = awgn_f0(f0, torch.Generator().manual_seed(0), target_noise_db=10.0)
    assert torch.equal(out, again)
