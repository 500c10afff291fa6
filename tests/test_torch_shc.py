"""The SHC band (kernel K1) against satpu: the port's plain version against
the Pallas kernel (interpret mode) and the gather branch, at the full
M/I/H/J of the anonymizer's YAAPT options; the CUDA kernel against the plain
version on the card.

jax is imported inside the tests that use it, so the card test also runs
where jax is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_shc.py``."""
import numpy as np
import pytest
import torch

from torch_parity import rel_err

M, MIN_SHC, I, H, J = 1045, 31, 226, 4, 21


def _mag(F, seed=7):
    return np.random.default_rng(seed).random((F, M)).astype(np.float32)


def _gather_ref(mag):
    """satpu's gather branch (yaapt.py shc_all_frames, the CPU default)."""
    import jax.numpy as jnp

    i_idx, h_idx, j_idx = np.arange(I), np.arange(H), np.arange(J)
    g = ((MIN_SHC + i_idx)[:, None, None] * (h_idx + 1)[None, :, None]
         + j_idx[None, None, :])
    m = jnp.asarray(mag)
    return np.asarray(jnp.sum(jnp.prod(
        m[:, jnp.asarray(g.reshape(-1))].reshape((mag.shape[0],) + g.shape), axis=2), axis=2))


def test_shc_geometry_is_the_flagship_one():
    from satpu_torch.models.anonymizer import YAAPT_OPTS
    from satpu_torch.ops.yaapt import _merged_params, shc_params

    g = shc_params(8192, _merged_params(YAAPT_OPTS))
    assert (g["min_shc"], g["n_out"], g["n_harm"], g["window_length"]) == (MIN_SHC, I, H, J)
    assert g["top_bin"] + g["half_window"] == M


def test_shc_plain_matches_pallas_kernel_interpret():
    """rel <= 1e-5: the same f32 products summed in another order."""
    import importlib

    import jax.numpy as jnp

    from satpu_torch.ops.yaapt import shc_band_plain

    Y = importlib.import_module("satpu.ops.yaapt")  # satpu.ops re-exports a yaapt function

    mag = _mag(40)
    ref = np.asarray(Y._shc_band_matmul_pallas(jnp.asarray(mag), MIN_SHC, I, H, J,
                                                block_frames=32, interpret=True))
    out = shc_band_plain(torch.from_numpy(mag), MIN_SHC, I, H, J).numpy()
    assert out.shape == (40, I)
    assert rel_err(out, ref) <= 1e-5


@pytest.mark.parametrize("F", [1, 37])
def test_shc_plain_matches_gather_branch(F):
    from satpu_torch.ops.yaapt import shc_band_plain

    mag = _mag(F, seed=F)
    out = shc_band_plain(torch.from_numpy(mag), MIN_SHC, I, H, J).numpy()
    assert rel_err(out, _gather_ref(mag)) <= 1e-5


def test_shc_band_on_cpu_takes_the_plain_version_and_counts_no_launch():
    from satpu_torch.ops.yaapt import shc_band, shc_band_plain

    mag = torch.from_numpy(_mag(5))
    before = shc_band.launches
    out = shc_band(mag, MIN_SHC, I, H, J)
    assert shc_band.launches == before
    assert torch.equal(out, shc_band_plain(mag, MIN_SHC, I, H, J))


def test_shc_band_rejects_reads_past_the_row():
    from satpu_torch.ops.yaapt import shc_band

    with pytest.raises(ValueError, match="column"):
        shc_band(torch.zeros(3, M - 1), MIN_SHC, I, H, J)
    with pytest.raises(ValueError, match="mag"):
        shc_band(torch.zeros(M), MIN_SHC, I, H, J)


def test_shc_band_rejects_other_devices():
    from satpu_torch.ops.yaapt import shc_band

    with pytest.raises(ValueError, match="cpu or cuda"):
        shc_band(torch.zeros(3, M, device="meta"), MIN_SHC, I, H, J)


@pytest.mark.gpu
def test_shc_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SHC kernel has no CPU mode")
    from satpu_torch.ops.yaapt import shc_band, shc_band_plain

    mag = torch.from_numpy(_mag(3001)).cuda()
    before = shc_band.launches
    out = shc_band(mag, MIN_SHC, I, H, J)
    torch.cuda.synchronize()
    assert shc_band.launches == before + 1
    assert rel_err(out.cpu().numpy(), shc_band_plain(mag, MIN_SHC, I, H, J).cpu().numpy()) <= 1e-5
