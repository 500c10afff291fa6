"""The traffic generator: the same inputs from a seed, and lengths that
keep each mix's stated totals."""
import json
import os

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts the repository on the path)
from portbench import gen
from portbench.reference import prep

TRAFFIC = os.path.join(tiny.ROOT, "portbench", "traffic")
MIXES = sorted(f[:-5] for f in os.listdir(TRAFFIC) if f.endswith(".json"))


def mix(name):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_keep_the_published_totals(name):
    m = mix(name)
    spec = m["lengths"]
    lengths = gen.corpus_lengths(spec, m["utterances"]) / gen.SR
    assert len(lengths) == m["utterances"]
    assert abs(lengths.mean() - spec["mean_s"]) < 1e-3 * spec["mean_s"]
    assert lengths.min() >= spec["min_s"] - 1e-4 and lengths.max() <= spec["max_s"] + 1e-4
    assert np.all(np.diff(lengths) >= 0)
    pub = m["published"]
    assert abs(pub["utterances"] * pub["mean_s"] / 3600 - pub["hours"]) < 0.02 * pub["hours"]
    assert spec["mean_s"] == pub["mean_s"] and spec["max_s"] == pub["max_s"]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_do_not_depend_on_the_seed(name):
    m = mix(name)
    a = gen.corpus_lengths(m["lengths"], m["utterances"])
    assert np.array_equal(a, gen.corpus_lengths(m["lengths"], m["utterances"]))


def test_chain_lengths_snap_to_whole_batches():
    m = mix("chain_libri100")
    raw = gen.corpus_lengths(m["lengths"], m["utterances"])
    allowed = prep.allowed_sample_lengths(raw, m["allowed_lengths"], m["coverage"])
    assert len(allowed) == m["allowed_lengths"]
    assert all(n % 480 == 0 for n in allowed)
    snapped = gen.whole_batches(gen.snap_lengths(raw, allowed), m["batch"])
    assert len(snapped) == m["utterances"]
    _, counts = np.unique(snapped, return_counts=True)
    assert np.all(counts % m["batch"] == 0)
    assert set(snapped) <= set(allowed)


def test_voiced_signal_is_the_same_for_a_seed_and_zero_past_its_length():
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        rng = np.random.default_rng(seed)
        f0, ph = gen.speakers(rng, {"f0_hz": [85.0, 255.0]}, 3)
        return gen.voiced(torch, [8000, 12000, 16000], 16000, f0, ph, g, torch.device("cpu"))

    a, b, c = make(5), make(5), make(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a[0, 8000:].abs().max()) == 0.0 and float(a[1, 12000:].abs().max()) == 0.0
    assert 0.05 < float(a[2, 4000:12000].abs().max()) < 1.0


def test_phone_walk_follows_the_bigram():
    _, _, trans = prep.random_bigram_den(5, 2, seed=0)
    walk = gen.random_phone_walk(trans, 200, np.random.default_rng(3))
    assert walk == gen.random_phone_walk(trans, 200, np.random.default_rng(3))
    assert trans[0, walk[0]] > 0
    assert all(trans[a, b] > 0 for a, b in zip(walk, walk[1:]))


def test_bucket_ladder_is_the_serving_clis():
    buckets = mix("anon_libri")["buckets"]
    assert gen.bucket_for(16000, buckets) == 16000
    assert gen.bucket_for(16001, buckets) == 32000
    assert gen.bucket_for(320001, buckets) == 640000
