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


def _gather_ref(mag, min_shc=MIN_SHC, n_out=I, n_harm=H, win=J):
    """satpu's gather branch (yaapt.py shc_all_frames, the CPU default)."""
    import jax.numpy as jnp

    i_idx, h_idx, j_idx = np.arange(n_out), np.arange(n_harm), np.arange(win)
    g = ((min_shc + i_idx)[:, None, None] * (h_idx + 1)[None, :, None]
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
    from satpu_torch.utils.trace import counters

    mag = torch.from_numpy(_mag(5))
    before = counters().get("k1.launches", 0)
    out = shc_band(mag, MIN_SHC, I, H, J)
    assert counters().get("k1.launches", 0) == before
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


# geometries of other YAAPT options: (options, n_harm, window_length); each
# takes the kernel's generic instantiation
OTHER_GEOMETRIES = [({"shc_numharms": 2.0}, 3, 21), ({"shc_window": 30.0}, 4, 15),
                    ({"shc_numharms": 5.0, "shc_window": 50.0}, 6, 25)]


def _geometry(opts):
    """(min_shc, n_out, n_harm, window_length) and mag's width for YAAPT
    options ``opts``."""
    from satpu_torch.ops.yaapt import _merged_params, shc_params

    g = shc_params(8192, _merged_params(opts))
    return ((g["min_shc"], g["n_out"], g["n_harm"], g["window_length"]),
            g["top_bin"] + g["half_window"])


@pytest.mark.parametrize("opts,n_harm,win", OTHER_GEOMETRIES)
def test_shc_other_geometries_plain_matches_pallas_kernel_interpret(opts, n_harm, win):
    """The plain version, the card kernel's reference, at the geometries of
    its generic instantiation."""
    import importlib

    import jax.numpy as jnp

    from satpu_torch.ops.yaapt import shc_band_plain

    Y = importlib.import_module("satpu.ops.yaapt")
    args, m = _geometry(opts)
    assert args[2:] == (n_harm, win)
    mag = np.random.default_rng(3).random((6, m)).astype(np.float32)
    ref = np.asarray(Y._shc_band_matmul_pallas(jnp.asarray(mag), *args, block_frames=8,
                                                interpret=True))
    out = shc_band_plain(torch.from_numpy(mag), *args).numpy()
    assert out.shape == ref.shape == (6, args[1])
    assert rel_err(out, ref) <= 1e-5


@pytest.mark.parametrize("numharms,n_harm", [(6.0, 7), (7.0, 8)])
def test_shc_band_on_cpu_takes_harmonic_counts_past_the_kernels(numharms, n_harm):
    """The kernel has room for 6 harmonics; the CPU path takes any count."""
    from satpu_torch.ops.yaapt import SHC_MAX_HARMONICS, shc_band

    args, m = _geometry({"shc_numharms": numharms})
    assert args[2] == n_harm > SHC_MAX_HARMONICS
    mag = np.random.default_rng(n_harm).random((5, m)).astype(np.float32)
    out = shc_band(torch.from_numpy(mag), *args).numpy()
    assert rel_err(out, _gather_ref(mag, *args)) <= 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SHC kernel has no CPU mode")


def _card_vs_plain(mag, *args):
    """One kernel call on the card against the plain version: (output, rel)."""
    from satpu_torch.ops.yaapt import shc_band, shc_band_plain
    from satpu_torch.utils.trace import counters

    before = counters().get("k1.launches", 0)
    out = shc_band(mag, *args)
    torch.cuda.synchronize()
    assert counters().get("k1.launches", 0) == before + 1
    return out, rel_err(out.cpu().numpy(), shc_band_plain(mag, *args).cpu().numpy())


@pytest.mark.gpu
def test_shc_cuda_kernel_matches_plain(cuda):
    from satpu_torch.ops.yaapt import shc_instantiation

    _, rel = _card_vs_plain(torch.from_numpy(_mag(3001)).cuda(), MIN_SHC, I, H, J)
    assert rel <= 1e-5
    assert shc_instantiation(H, J) == "fixed"


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 37, 7, 8, 9, 16000])
def test_shc_cuda_kernel_ragged_and_serving_frames(cuda, F):
    """Frames one under, at and over a multiple of the block's 4, and the
    B=32 x 10 s serving batch; two calls give the same bits."""
    from satpu_torch.ops.yaapt import shc_band

    mag = torch.from_numpy(_mag(F, seed=F)).cuda()
    out, rel = _card_vs_plain(mag, MIN_SHC, I, H, J)
    assert rel <= 1e-5
    assert torch.equal(out, shc_band(mag, MIN_SHC, I, H, J))


@pytest.mark.gpu
@pytest.mark.parametrize("m,min_shc", [(1046, 31), (1047, 30), (1048, 29)])
def test_shc_cuda_kernel_fixed_geometry_other_row_widths(cuda, m, min_shc):
    """The unrolled instantiation at every row width modulo 4 (its staging
    is specialised on it) and other first candidates."""
    from satpu_torch.ops.yaapt import shc_instantiation

    mag = torch.from_numpy(np.random.default_rng(m).random((203, m)).astype(np.float32)).cuda()
    _, rel = _card_vs_plain(mag, min_shc, I, H, J)
    assert rel <= 1e-5
    assert shc_instantiation(H, J) == "fixed"


@pytest.mark.gpu
@pytest.mark.parametrize("opts,n_harm,win", OTHER_GEOMETRIES)
def test_shc_cuda_kernel_generic_geometries(cuda, opts, n_harm, win):
    from satpu_torch.ops.yaapt import shc_band, shc_instantiation

    args, m = _geometry(opts)
    mag = torch.from_numpy(np.random.default_rng(5).random((1001, m)).astype(np.float32)).cuda()
    out, rel = _card_vs_plain(mag, *args)
    assert rel <= 1e-5
    assert shc_instantiation(n_harm, win) == "generic"
    assert torch.equal(out, shc_band(mag, *args))


@pytest.mark.gpu
def test_shc_cuda_kernel_takes_offset_and_strided_inputs(cuda):
    """A view at an odd storage offset runs as it is (single-word reads); a
    transposed one is copied to contiguous by the wrapper."""
    flat = torch.from_numpy(_mag(101).reshape(-1)).cuda()
    offset = torch.cat([flat[:1], flat]).narrow(0, 1, flat.numel()).view(101, M)
    assert offset.storage_offset() == 1 and offset.is_contiguous()
    strided = offset.t().contiguous().t()
    assert not strided.is_contiguous()
    for mag in (offset, strided):
        _, rel = _card_vs_plain(mag, MIN_SHC, I, H, J)
        assert rel <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_harm", [0, 7])
def test_shc_band_rejects_harmonics_the_kernel_has_no_room_for(cuda, n_harm):
    from satpu_torch.ops.yaapt import SHC_MAX_HARMONICS, shc_band

    assert SHC_MAX_HARMONICS == 6
    with pytest.raises(ValueError, match="harmonics"):
        shc_band(torch.zeros(2, 4000, device="cuda"), MIN_SHC, I, n_harm, J)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a launch on another card than the current one")


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", ["fixed", "generic"])
def test_shc_cuda_kernel_launches_on_its_tensors_card(two_cards, geometry):
    """K1 on a cuda:1 tensor while cuda:0 is current (a serving-mesh
    replica, ``anonymize --device cuda:1``), then on cuda:0 and on cuda:1
    again (each card keeps its own launch configuration): the plain
    version's output on the tensor's card, two calls bitwise equal, one
    launch a call, and cuda:0 still current."""
    from satpu_torch.ops.yaapt import shc_band, shc_instantiation

    args, m = ((MIN_SHC, I, H, J), M) if geometry == "fixed" else _geometry(
        OTHER_GEOMETRIES[0][0])
    mag = torch.from_numpy(np.random.default_rng(3).random((2003, m)).astype(np.float32))
    with torch.cuda.device(0):
        for card in (1, 0, 1):
            x = mag.to(f"cuda:{card}")
            out, rel = _card_vs_plain(x, *args)
            assert out.device == x.device and rel <= 1e-5
            assert torch.equal(out, shc_band(x, *args))
            assert shc_instantiation(*args[2:]) == geometry
            assert torch.cuda.current_device() == 0
