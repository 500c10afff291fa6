"""The ASV training data path of satpu_torch against satpu's, on the CPU,
from the same seeds and files:

- ``ops.augment.data_augmentation`` for each pipeline key (and two a call)
  on synthetic noise and RIR databases that the test writes, from the same
  ``random.Random`` seed: bit-exact, but the scipy low-pass of
  ``phone_filtering`` (the same scipy call on both sides) held at 1e-6 abs;
  ``load_augmentation`` equal; ``spec_augment``'s Snowdar masks;
- ``utils.schedules``: ``one_cycle`` and the exponential decay against
  satpu's, which computes in f32 (held to two f32 ulps of lr_max), and the
  kaldi job / lr math exactly;
- ``SideSampler`` indices and ``SideSet`` crops (random shift, dither,
  augmentation with length repair) and batches over two epochs:
  bit-exact; ``kaldi_data`` offset reads and utt2dur."""
import os
import random

import numpy as np
import pytest
import torch

from augment_fixture import PIPELINE, write_aug_dbs
from torch_parity import harmonic


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return write_aug_dbs(str(tmp_path_factory.mktemp("aug")))


def _speech(n=24000, seed=0):
    return harmonic(n, 140.0, seed=seed)[0][None, :]


@pytest.mark.parametrize("key", PIPELINE + ["two"])
def test_data_augmentation_matches_satpu(dbs, key):
    """Each key alone (20 draws a key, so that every branch of add_noise and
    both codecs come up), and ``aug_number`` 2 over the whole pipeline."""
    from satpu.ops.augment import data_augmentation as J
    from satpu_torch.ops.augment import data_augmentation as P

    td = ({"pipeline": PIPELINE, "aug_number": 2} if key == "two"
          else {"pipeline": [key], "add_noise": {"babble_noise": "true"}})
    rj, rp = random.Random(5), random.Random(5)
    changed = 0
    for i in range(20):
        x = _speech(seed=i)
        ref, out = J(x, td, 16000, dbs["noise_db"], dbs["rir_db"], rng=rj), P(
            x, td, 16000, dbs["noise_db"], dbs["rir_db"], rng=rp)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        if key in ("phone_filtering", "two"):
            assert np.abs(out - ref).max() <= 1e-6, i
        else:
            np.testing.assert_array_equal(out, ref, err_msg=f"draw {i}")
        changed += out.shape != x.shape or not np.array_equal(out, x)
    assert changed == (0 if key == "none" else 20)
    assert rj.random() == rp.random()  # the streams moved in step


def test_silent_speech_dithered_from_the_numpy_generator(dbs):
    """Noise on silent speech: satpu dithers it from numpy's global
    generator, the port from the caller's RandomState with the same seed."""
    from satpu.ops.augment import data_augmentation as J
    from satpu_torch.ops.augment import data_augmentation as P

    td = {"pipeline": ["add_noise"]}
    x = np.zeros((1, 8000), np.float32)
    np.random.seed(11)
    ref = J(x, td, 16000, dbs["noise_db"], None, rng=random.Random(1))
    out = P(x, td, 16000, dbs["noise_db"], None, rng=random.Random(1),
            np_rng=np.random.RandomState(11))
    np.testing.assert_array_equal(out, ref)


def test_unknown_augmentation_is_refused():
    from satpu_torch.ops.augment import data_augmentation

    with pytest.raises(ValueError, match="not a valid augmentation"):
        data_augmentation(np.zeros(100, np.float32), {"pipeline": ["echo"]})


def test_load_augmentation_matches_satpu(dbs, tmp_path):
    """Inline lenient JSON (a comment, trailing commas) and a .json file
    path give satpu's (transform_dict, noise_db, rir_db); empty gives Nones."""
    from satpu.ops.augment import load_augmentation as J
    from satpu_torch.ops.augment import load_augmentation as P

    path = str(tmp_path / "aug.json")
    with open(path, "w") as f:
        f.write(dbs["inline"])
    for value in (dbs["inline"], path):
        out = P(value)
        assert out == J(value)
        assert out[0]["pipeline"] == PIPELINE and out[1] == dbs["noise_db"]
        assert out[2] == dbs["rir_db"]
    assert P("") == J("") == (None, None, None)


def test_spec_augment_snowdar():
    """spec_augment on [B, F, T]: zeroed bands shared by the batch, the
    frequency masks rescaling the rest by F / (F - f), from the generator
    (the same seed, the same masks); random_rows / random_cols vary the count."""
    from satpu_torch.ops.augment import spec_augment

    x = torch.ones(3, 40, 100)
    for seed in range(8):
        out = spec_augment(x, torch.Generator().manual_seed(seed), rows=2, cols=2)
        again = spec_augment(x, torch.Generator().manual_seed(seed), rows=2, cols=2)
        assert torch.equal(out, again)
        assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
        zero_f = (out[0] == 0).all(dim=1)
        zero_t = (out[0] == 0).all(dim=0)
        assert zero_f.sum() <= 2 * 8 and zero_t.sum() <= 2 * 20
        kept = out[0][~zero_f][:, ~zero_t]
        assert kept.numel() == 0 or float(kept.min()) >= 1.0  # rescaled up, never down
    zeroed = {int((spec_augment(x, torch.Generator().manual_seed(s), frequency=0.5, rows=3,
                                random_rows=True)[0] == 0).all(dim=1).sum())
              for s in range(20)}
    assert len(zeroed) > 3 and max(zeroed) <= 3 * 20


def test_schedules_match_satpu():
    """one_cycle at the recipe's div_factor 4 over several lengths, and the
    exponential per-epoch decay: satpu computes in f32, the port in Python
    floats, so each value is held to 2 f32 ulps of lr_max; the kaldi job and
    lr math and the warm-restart schedule are plain Python in both: equal."""
    import jax.numpy as jnp

    from satpu.utils import schedules as J
    from satpu_torch.utils import schedules as P

    ulp = float(np.finfo(np.float32).eps)
    for total in (7, 10, 75, 100):
        j, p = J.one_cycle(1e-3, total, div_factor=4.0), P.one_cycle(1e-3, total, div_factor=4.0)
        for s in range(total + 3):
            assert abs(p(s) - float(j(jnp.asarray(s, jnp.int32)))) <= 2 * ulp * 1e-3, (total, s)
    assert P.one_cycle(1.0, 100, div_factor=4.0)(0) == 0.25
    assert P.one_cycle(1.0, 100, div_factor=4.0)(30) == 1.0
    for s in range(40):  # satpu's train_asv exponential schedule, 5 steps an epoch
        ref = 1e-3 * 0.2 ** (jnp.asarray(s, jnp.int32) // 5).astype(jnp.float32)
        assert abs(1e-3 * 0.2 ** (s // 5) - float(ref)) <= 2 * ulp * 1e-3
    for e in range(5):
        assert P.exponential_decay_per_epoch(2e-4, 0.999)(e) == \
            J.exponential_decay_per_epoch(2e-4, 0.999)(e)
    cj, cp = (m.cosine_warm_restarts_decay_warmup(1e-3, 10, 2.0, 1e-5, 4, 0.5) for m in (J, P))
    assert [cp(s) for s in range(50)] == [cj(s) for s in range(50)]
    for args in ((3, 10, 2, 1, 8), (0, 1, 2, 2, 8), (9, 10, 1, 1, 16)):
        assert P.get_current_num_jobs(*args) == J.get_current_num_jobs(*args)
    for kind in ("none", "linear", "exponential"):
        for it in (0, 4, 9):
            a = (it, 3, 10, it * 2, 30, 1e-3, 1e-4, kind)
            assert P.get_learning_rate(*a) == J.get_learning_rate(*a)


def _data_dir(root, n_spk=4, utts=3, seed=0):
    """A kaldi dir of voiced utterances of 0.9-2.6 s; no utt2dur."""
    from satpu_torch.utils import kaldi_data

    os.makedirs(root, exist_ok=True)
    wav_scp, utt2spk = {}, {}
    for s in range(n_spk):
        for u in range(utts):
            n = 14400 + 4800 * u + 1600 * s
            x, _ = harmonic(n, 100.0 + 40 * s + 7 * u, seed=seed + 10 * s + u)
            utt = f"spk{s}-u{u}"
            wav_scp[utt] = os.path.join(root, utt + ".wav")
            kaldi_data.write_wav(wav_scp[utt], x, 16000)
            utt2spk[utt] = f"spk{s}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(root, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(root, "utt2spk"))
    return root


def test_kaldi_offset_reads_and_utt2dur(tmp_path):
    """load_wav_from_scp(entry, offset, n) and get_utt2dur (written when
    missing, then read back) as satpu's."""
    from satpu.utils import kaldi_data as J
    from satpu_torch.utils import kaldi_data as P

    d = _data_dir(str(tmp_path / "d"), n_spk=2, utts=2)
    entry = P.read_wav_scp(os.path.join(d, "wav.scp"))["spk1-u1"]
    for off, n in ((0, -1), (100, 500), (20000, 5000), (0, 100000)):
        np.testing.assert_array_equal(P.load_wav_from_scp(entry, off, n)[0],
                                      J.load_wav_from_scp(entry, off, n)[0])
    assert not os.path.exists(os.path.join(d, "utt2dur"))
    dur = P.get_utt2dur(d)
    assert os.path.exists(os.path.join(d, "utt2dur"))
    assert dur == P.get_utt2dur(d) == J.get_utt2dur(d)
    assert dur["spk1-u1"] == pytest.approx((14400 + 4800 + 1600) / 16000, abs=1e-6)


def test_side_sampler_matches_satpu():
    """Indices over three epochs, two ranks, speakers with fewer chunks than
    examples_per_speaker (picks with replacement)."""
    from satpu.sidekit.dataset import SideSampler as J
    from satpu_torch.sidekit.dataset import SideSampler as P

    spk = np.concatenate([np.repeat(np.arange(5), 7), [5, 5]])
    for rank, nproc in ((0, 1), (1, 2)):
        kw = dict(spk_count=6, examples_per_speaker=4, samples_per_speaker=3, batch_size=24,
                  seed=9, rank=rank, num_process=nproc)
        p, j = P(spk, **kw), J(spk, **kw)
        assert len(p) == len(j) == 3 * 6 * 4 // nproc
        for epoch in range(3):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(p) == list(j)
    with pytest.raises(ValueError, match="multiple"):
        P(spk, 6, 4, 3, batch_size=10)


@pytest.mark.parametrize("aug", [False, True], ids=["plain", "augmented"])
def test_side_set_crops_and_batches_match_satpu(tmp_path, dbs, aug):
    """SideSet.from_data_dir: the same chunk grid; over two epochs the same
    batches, with validation's double reads between them (they move the
    random streams, as in train_asv), bit for bit: random shift and the
    set's random.Random, dither from the set's RandomState against satpu's
    seeded global numpy generator, augmentation (speed perturbation's
    length repaired)."""
    from satpu.sidekit.dataset import SideSampler as JS
    from satpu.sidekit.dataset import SideSet as JSet
    from satpu_torch.ops.augment import load_augmentation
    from satpu_torch.sidekit.dataset import SideSampler, SideSet

    d = _data_dir(str(tmp_path / "d"))
    tp, noise_db, rir_db = load_augmentation(dbs["inline"]) if aug else (None, None, None)
    kw = dict(duration=0.5, transform_pipeline=tp, noise_db=noise_db, rir_db=rir_db, seed=21)
    port, ref = SideSet.from_data_dir(d, **kw), JSet.from_data_dir(d, **kw)
    assert [(c.utt, c.offset, c.spk_idx) for c in port.chunks] == \
        [(c.utt, c.offset, c.spk_idx) for c in ref.chunks]
    assert len(port) == len(ref) == 28 and port.speakers == ref.speakers
    sp = SideSampler(port.chunk_speakers, 4, 2, 2, 8, seed=21)
    sj = JS(ref.chunk_speakers, 4, 2, 2, 8, seed=21)
    np.random.seed(21)  # satpu's dither stream
    n = 0
    for epoch in range(2):
        sp.set_epoch(epoch)
        sj.set_epoch(epoch)
        for (w, s), (jw, js) in zip(port.batches(sp, 8), ref.batches(sj, 8)):
            assert w.shape == (8, 8000) and w.dtype == np.float32
            np.testing.assert_array_equal(w, jw)
            np.testing.assert_array_equal(s, js)
            n += 1
        for i in range(0, len(port), 3):  # validation: audio, then label
            np.testing.assert_array_equal(port[i][0], ref[i][0])
            assert port[i][1] == ref[i][1]
    assert n == 4
    assert port.rng.random() == ref.rng.random()
