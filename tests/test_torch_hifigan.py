"""satpu_torch CoreHifiGan against satpu on the CPU, weights carried across
by the weight bridge: f32 parity, the bf16 serving policy against satpu's
f32 output, and the iSTFT head."""
import numpy as np
import pytest
import torch

import jax

from torch_parity import jax_variables_numpy, rel_err

SMALL = dict(input_dim=20, upsample_rates=(5, 4), upsample_kernel_sizes=(11, 8),
             upsample_initial_channel=32)


def _pair(**extra):
    from satpu.models.hifigan import CoreHifiGan as JGen
    from satpu.models.hifigan import CoreHifiGanConfig as JCfg
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.models.hifigan import CoreHifiGan, CoreHifiGanConfig

    x = np.random.default_rng(0).standard_normal((2, 30, SMALL["input_dim"])).astype(np.float32)
    jgen = JGen(JCfg(**SMALL, **extra))
    variables = jax_variables_numpy(jax.jit(jgen.init)(jax.random.PRNGKey(0), x))
    ref = jax.jit(jgen.apply)(variables, x)
    sd = from_satpu_variables(variables)
    return x, variables, ref, sd, lambda **kw: CoreHifiGan(
        CoreHifiGanConfig(**SMALL, **{**extra, **kw})).eval()


@pytest.fixture(scope="module")
def wave_pair():
    return _pair()


def test_core_hifigan_f32_matches_satpu(wave_pair):
    """rel <= 1e-4 on the waveform."""
    x, _, ref, sd, make = wave_pair
    gen = make()
    gen.load_state_dict(sd)
    with torch.no_grad():
        out = gen(torch.from_numpy(x).transpose(1, 2)).numpy()
    ref = np.asarray(ref)[..., 0]
    assert out.shape == (2, 1, 30 * 20 + 1)  # reflection pad (1, 0) adds a sample
    assert rel_err(out[:, 0], ref) <= 1e-4, rel_err(out[:, 0], ref)


def test_core_hifigan_bf16_policy_against_satpu_f32(wave_pair):
    """bf16 convs (weights normed in f32 first) vs satpu at f32: rel <= 1e-2."""
    x, _, ref, sd, make = wave_pair
    gen = make(compute_dtype="bfloat16")
    gen.load_state_dict(sd)
    with torch.no_grad():
        out = gen(torch.from_numpy(x).transpose(1, 2))
    assert out.dtype == torch.float32
    err = rel_err(out.numpy()[:, 0], np.asarray(ref)[..., 0])
    assert err <= 1e-2, err


def test_core_hifigan_istft_head_matches_satpu():
    x, _, (ref_spec, ref_phase), sd, make = _pair(istft_out=True)
    gen = make()
    gen.load_state_dict(sd)
    with torch.no_grad():
        spec, phase = gen(torch.from_numpy(x).transpose(1, 2))
    assert rel_err(spec.transpose(1, 2).numpy(), ref_spec) <= 1e-4
    assert rel_err(phase.transpose(1, 2).numpy(), ref_phase) <= 1e-4


def test_weight_norm_resblock2_matches_satpu():
    from satpu.models.hifigan import ResBlock2 as JRB
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.models.hifigan import ResBlock2

    x = np.random.default_rng(1).standard_normal((2, 40, 8)).astype(np.float32)
    jrb = JRB(8, 3, (1, 3))
    variables = jax_variables_numpy(jrb.init(jax.random.PRNGKey(1), x))
    rb = ResBlock2(8, 3, (1, 3)).eval()
    rb.load_state_dict(from_satpu_variables(variables))
    with torch.no_grad():
        out = rb(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert rel_err(out, jrb.apply(variables, x)) <= 1e-5
