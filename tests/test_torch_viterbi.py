"""YAAPT's Viterbi DPs (kernel K4): on the CPU, the wrapper's contract and
the port's plain version against satpu's sequential ``viterbi_path_scan``
on rows with exact ties, INF-padded tails and NaN transitions; on the card,
the CUDA kernel's path bitwise equal to the plain version's.

jax is imported inside the tests that use it, so the card tests also run
where jax is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_viterbi.py``."""
import numpy as np
import pytest
import torch

from satpu_torch.bin.pipeline import DEFAULT_BUCKETS
from satpu_torch.models.anonymizer import YAAPT_OPTS
from satpu_torch.ops import yaapt as Y
from satpu_torch.utils import cuda_build

P = Y._merged_params(YAAPT_OPTS)
# the frames of each serving rung (50 ... 1000), LibriSpeech's longest
# utterance (35 s) and a 70 s one
SERVING_T = [Y.num_frames(n, P) for n in DEFAULT_BUCKETS] + [1750, 3500]


def _costs(B, C, T, kind, seed=0):
    """(local [B, C, T], trans [B, C, C, T]) f32 tensors. ``int``: costs
    0-2, so minima tie; ``real``: uniform; ``pad``: real up to a random
    num_valid a row, then dynamic5's padding (zero local cost, identity
    transitions, INF elsewhere); ``nan``: real with a few NaN entries."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        local = rng.integers(0, 3, (B, C, T)).astype(np.float32)
        trans = rng.integers(0, 3, (B, C, C, T)).astype(np.float32)
    else:
        local = rng.random((B, C, T), dtype=np.float32)
        trans = rng.random((B, C, C, T), dtype=np.float32) * 3
    if kind == "pad":
        num_valid = rng.integers(0, T + 1, B)
        num_valid[0] = T // 2
        eye = np.eye(C, dtype=bool)[:, :, None]
        for b, n in enumerate(num_valid):
            local[b, :, n:] = 0.0
            trans[b, :, :, n:] = np.where(eye, 0.0, Y.INF)
    if kind == "nan":
        trans[rng.random(trans.shape) < 0.03] = np.nan
        local[rng.random(local.shape) < 0.01] = np.nan
    return torch.from_numpy(local), torch.from_numpy(trans)


def _final_costs(B, T, seed=0):
    """dynamic_final's own (local, trans view) on random candidates [B, 6,
    T] whose pitches repeat from frame to frame, row 0 without a voiced best
    candidate: its mean pitch is 0 and its transitions hold NaN."""
    rng = np.random.default_rng(seed)
    pitch = rng.choice(np.float32([0.0, 100.0, 150.0, 200.0]), (B, 6, T))
    pitch[0, 4] = 0.0  # the best candidate's row (C - 2)
    merit = rng.random((B, 6, T), dtype=np.float32)
    energy = rng.random((B, T), dtype=np.float32)
    seen = []

    def capture(local, trans):
        seen.append((local, trans))
        return Y.viterbi_path_plain(local, trans)

    op = Y.viterbi_path_op
    Y.viterbi_path_op = capture
    try:
        Y.dynamic_final(torch.from_numpy(pitch), torch.from_numpy(merit),
                        torch.from_numpy(energy), P)
    finally:
        Y.viterbi_path_op = op
    local, trans = seen[0]
    assert torch.isnan(trans[0]).any() and not torch.isnan(trans[1:]).any()
    assert not trans.is_contiguous()  # the [prev, next] tensor's transposed view
    return local, trans


def _scan(local, trans):
    """satpu's sequential Viterbi (lax.scan), row by row."""
    import jax
    import jax.numpy as jnp

    from satpu.ops.yaapt import viterbi_path_scan

    scan = jax.jit(viterbi_path_scan)
    return np.stack([np.asarray(scan(jnp.asarray(local[b].numpy()),
                                     jnp.asarray(trans[b].contiguous().numpy())))
                     for b in range(local.shape[0])])


@pytest.mark.parametrize("C,kind", [(4, "int"), (6, "int"), (4, "pad"), (6, "pad"),
                                    (6, "nan")])
def test_viterbi_plain_matches_satpu_scan(C, kind):
    """Ties go to the highest candidate, padded tails stay on their
    candidate, and a NaN cost wins, as in satpu's scan."""
    local, trans = _costs(3, C, 40, kind, seed=C)
    out = Y.viterbi_path_plain(local, trans).numpy()
    np.testing.assert_array_equal(out, _scan(local, trans))


def test_viterbi_plain_matches_satpu_scan_on_a_row_with_zero_mean_pitch():
    local, trans = _final_costs(3, 40)
    np.testing.assert_array_equal(Y.viterbi_path_plain(local, trans).numpy(),
                                  _scan(local, trans))


def test_viterbi_path_on_cpu_takes_the_plain_version_and_counts_no_launch():
    from satpu_torch.utils.trace import counters

    local, trans = _costs(2, 6, 30, "int")
    before = counters().get("k4.launches", 0)
    out = Y.viterbi_path(local, trans.transpose(1, 2))
    assert counters().get("k4.launches", 0) == before
    assert out.dtype == torch.int64 and out.shape == (2, 30)
    assert torch.equal(out, Y.viterbi_path_plain(local, trans.transpose(1, 2)))


def test_viterbi_path_on_cpu_takes_any_candidate_count():
    local, trans = _costs(2, Y.VITERBI_MAX_CANDIDATES + 3, 12, "int")
    np.testing.assert_array_equal(Y.viterbi_path(local, trans).numpy(), _scan(local, trans))


@pytest.mark.parametrize("local,trans,error,match", [
    (torch.zeros(6, 5), torch.zeros(2, 6, 6, 5), ValueError, "local"),
    (torch.zeros(2, 6, 5), torch.zeros(2, 6, 6), ValueError, "local"),
    (torch.zeros(2, 6, 5), torch.zeros(2, 4, 4, 5), ValueError, "trans"),
    (torch.zeros(2, 6, 5), torch.zeros(2, 6, 6, 4), ValueError, "trans"),
    (torch.zeros(2, 6, 0), torch.zeros(2, 6, 6, 0), ValueError, "T >= 1"),
    (torch.zeros(2, 6, 5, dtype=torch.float64), torch.zeros(2, 6, 6, 5), TypeError, "float32"),
    (torch.zeros(2, 6, 5), torch.zeros(2, 6, 6, 5, dtype=torch.float16), TypeError, "float32"),
    (torch.zeros(2, 6, 5, device="meta"), torch.zeros(2, 6, 6, 5, device="meta"), ValueError,
     "cpu or cuda"),
])
def test_viterbi_path_rejects_what_it_does_not_take(local, trans, error, match):
    with pytest.raises(error, match=match):
        Y.viterbi_path(local, trans)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Viterbi kernel has no CPU mode")


def _card_vs_plain(local, trans):
    """One K4 call on the card: its path, and whether it is the plain
    version's (computed on the CPU) bit for bit."""
    from satpu_torch.utils.trace import counters

    before = counters().get("k4.launches", 0)
    out = Y.viterbi_path(local.cuda(), trans.cuda())
    torch.cuda.synchronize()
    assert counters().get("k4.launches", 0) == before + 1
    assert out.dtype == torch.int64 and out.device.type == "cuda"
    return out, torch.equal(out.cpu(), Y.viterbi_path_plain(local, trans))


@pytest.mark.gpu
@pytest.mark.parametrize("T", SERVING_T)
@pytest.mark.parametrize("C", [4, 6])
def test_k4_matches_plain_at_the_serving_shapes(cuda, C, T):
    """B=32 at every rung's frame count and past the last rung, padded tails
    as dynamic5 pads them; two calls bitwise equal."""
    local, trans = _costs(32, C, T, "pad", seed=T)
    out, same = _card_vs_plain(local, trans)
    assert same
    assert torch.equal(out, Y.viterbi_path(local.cuda(), trans.cuda()))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int", "real", "pad", "nan"])
@pytest.mark.parametrize("C", [4, 6])
def test_k4_ties_padding_and_nan(cuda, C, kind):
    for T in (1, 2, 31, 32, 33, 97):
        local, trans = _costs(5, C, T, kind, seed=T)
        assert _card_vs_plain(local, trans)[1], (C, kind, T)


@pytest.mark.gpu
def test_k4_on_a_row_with_zero_mean_pitch(cuda):
    """dynamic_final's own inputs: a transposed view of [prev, next], NaN in
    the row whose mean pitch is 0."""
    local, trans = _final_costs(4, 300)
    assert _card_vs_plain(local, trans)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 6])
def test_k4_reads_a_transposed_view_without_a_copy(cuda, C):
    local, trans = _costs(8, C, 500, "real")
    view = trans.cuda().transpose(1, 2)
    assert not view.is_contiguous()
    out = Y.viterbi_path(local.cuda(), view)
    assert torch.equal(out.cpu(), Y.viterbi_path_plain(local, trans.transpose(1, 2)))
    assert not torch.equal(out.cpu(), Y.viterbi_path_plain(local, trans))


@pytest.mark.gpu
@pytest.mark.parametrize("C,kind", [(4, "int"), (6, "pad")])
def test_k4_backpointers_in_device_memory(cuda, C, kind):
    """A T whose C T backpointer bytes do not fit a block's shared memory
    takes the wrapper's device-memory scratch."""
    lib = cuda_build.load("viterbi")
    T = 8000
    while not lib.satpu_viterbi_scratch_bytes(C, T):
        T *= 2
    assert lib.satpu_viterbi_scratch_bytes(C, T // 2) == 0
    local, trans = _costs(2, C, T + 17, kind, seed=C)
    assert _card_vs_plain(local, trans)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 3, 5, 9, 16])
def test_k4_generic_instantiation(cuda, C):
    """Every C but 4 and 6 (the unrolled instantiations) takes the generic one."""
    for kind in ("int", "pad"):
        local, trans = _costs(6, C, 130, kind, seed=C)
        assert _card_vs_plain(local, trans)[1], (C, kind)


@pytest.mark.gpu
def test_k4_rejects_candidates_past_its_maximum(cuda):
    """16 candidates run (the generic test), 17 raise before the launch."""
    assert Y.VITERBI_MAX_CANDIDATES == 16
    local, trans = _costs(2, 17, 10, "int")
    with pytest.raises(ValueError, match="candidates"):
        Y.viterbi_path(local.cuda(), trans.cuda())


@pytest.mark.gpu
def test_k4_two_launches_per_yaapt_batch(cuda):
    """yaapt_batch at the serving options: one K4 launch a DP, and the F0
    of the plain DPs run on the card bit for bit."""
    from satpu_torch.utils.trace import counters

    rng = np.random.default_rng(0)
    t = np.arange(48000) / 16000.0
    x = np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal(t.size)
                  for f in (110.0, 190.0, 290.0)] + [0.05 * rng.standard_normal(t.size)])
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    before = counters().get("k4.launches", 0)
    f0 = Y.yaapt_batch(x, P)
    torch.cuda.synchronize()
    assert counters().get("k4.launches", 0) == before + 2
    op = Y.viterbi_path_op
    Y.viterbi_path_op = Y.viterbi_path_plain
    try:
        plain = Y.yaapt_batch(x, P)
    finally:
        Y.viterbi_path_op = op
    assert counters().get("k4.launches", 0) == before + 2
    assert torch.equal(f0, plain) and bool((f0[:3] > 0).float().mean() > 0.7)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a launch on another card than the current one")


@pytest.mark.gpu
def test_k4_launches_on_its_tensors_card(two_cards):
    local, trans = _costs(4, 6, 200, "pad")
    with torch.cuda.device(0):
        for card in (1, 0, 1):
            out = Y.viterbi_path(local.to(f"cuda:{card}"), trans.to(f"cuda:{card}"))
            assert out.device == torch.device(f"cuda:{card}")
            assert torch.equal(out.cpu(), Y.viterbi_path_plain(local, trans))
            assert torch.cuda.current_device() == 0
