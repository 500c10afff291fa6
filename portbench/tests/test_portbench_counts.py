"""The operation and byte counters against hand counts and against the
shapes that the reference network really produces."""
import copy

import pytest
import torch

import tiny
from portbench import counts
from portbench.reference import anonymizer as ref_anon
from portbench.reference import asrbn as ref_asrbn


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert counts.bound_s(67e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_k1_counts_by_hand():
    p = {"sr": 16000.0, "frame_length": 35.0, "frame_space": 20.0, "fft_length": 8192.0,
         "shc_window": 40.0, "f0_min": 60.0, "f0_max": 400.0, "shc_pwidth": 50.0,
         "shc_numharms": 3.0}
    g = counts.yaapt_geometry(16000, p)
    # 280-sample frames every 320 samples over 16000 + 2 x 280 samples
    assert g["frames"] == len(range(280, 16560 - 280, 320))
    assert (g["window"], g["min_shc"], g["harm"]) == (21, 31, 4)  # 40 Hz / (16000 / 8192)
    assert g["n_out"] == int(500 / (16000 / 8192)) - 31 + 1
    rows = 2 * g["frames"]
    ops = rows * g["n_out"] * 21 * 4
    nbytes = rows * (g["columns"] - 31 + g["n_out"]) * 4
    assert counts.k1_bound_s(2, 16000, p) == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))


def test_k2_counts_by_hand():
    f, b = counts.k2_bound_s(batch=2, frames=3, states=4, nnz=5)
    a = 5 * 6 + 5 * 4
    assert f == pytest.approx(max(2 * 2 * 3 * 5 / 67e12,
                                  (4 * (2 * 24 + 8 + 8 + 4 * 8) + a) / 3.35e12))
    assert b == pytest.approx(max(4 * 2 * 3 * 5 / 67e12,
                                  (4 * (8 + 4 * 8 + 48 + 8 + 48) + a) / 3.35e12))


def test_k3_counts_by_hand():
    # two rows: (3 states, 5 live arcs, 4 pdfs on them) and (2, 4, 4); 6 frames
    f, b = counts.k3_bound_s(frames=6, rows=[(3, 5, 4), (2, 4, 4)])
    gathered_and_alphas = 4 * (6 * 5 + 7 * 3 + 6 * 4 + 7 * 2)
    assert f == pytest.approx(max(2 * 6 * 9 / 67e12, gathered_and_alphas / 3.35e12))
    assert b == pytest.approx(max(4 * 6 * 9 / 67e12,
                                  (gathered_and_alphas + 4 * 6 * (4 + 4)) / 3.35e12))


def test_k3_bound_at_the_chain_cells_longest_batch():
    """B=16, T=661, each row 221 states, 440 live arcs and 405 pdfs on them
    (the cell's graphs hold 384-422): the gathered log-likelihoods and the
    alphas, 28.0 MB; K3b also writes a frame's posterior for each of a row's
    pdfs, 17.1 MB, and not the dense [B, T, 3280] posteriors, which the zero
    fill writes outside ``num_bwd``."""
    f, b = counts.k3_bound_s(661, [(221, 440, 405)] * 16)
    assert f * 3.35e12 == pytest.approx(4 * 16 * (661 * 440 + 662 * 221))
    assert (b - f) * 3.35e12 == pytest.approx(17.13e6, rel=1e-3)


def net(**kw):
    n = copy.deepcopy(tiny.cell("chain_libri100_b16").config["build"])
    n.update(kw)
    return n


@pytest.mark.parametrize("samples", [480 * 40, 480 * 57])
def test_tdnnf_frames_match_the_reference_network(samples):
    n = net()
    model = ref_asrbn.TDNNFNet(ref_asrbn.TDNNFNetConfig(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in n.items()})).eval()
    with torch.no_grad():
        chain_out, _ = model(torch.zeros(1, samples))
        bn = model.extract_bn(torch.zeros(1, samples))
    assert counts.tdnnf_frames(n, samples, False) == chain_out.shape[1]
    assert counts.tdnnf_frames(n, samples, True) == bn.shape[1]


def test_tdnnf_flops_by_hand():
    n = net(kernel_size_list=[3, 1], subsampling_factor_list=[1, 1],
            kernel_size_list_after=[1], subsampling_factor_list_after=[1], codebook_size=8)
    # 1600 samples: 10 fbank frames + 2 x 1 of padding, a width-3 window -> 10
    t = 10
    h, b, pb, o = n["hidden_dim"], n["bottleneck_dim"], n["prefinal_bottleneck_dim"], 40
    serve = 2 * t * (80 * 3 * b + b * h + h * pb) + 2 * pb * 8 * t  # last: linearB and VQ
    assert counts.tdnnf_flops(n, 1, 1600, True) == serve
    full = (2 * t * (80 * 3 * b + b * h + h * pb + pb * h + h * b + b * h)
            + 2 * 2 * t * (h * pb + pb * h + h * o) + 2 * pb * 8 * t)
    assert counts.tdnnf_flops(n, 3, 1600, False) == 3 * full


def test_generator_output_length_matches_the_reference():
    c = tiny.cell("anon_libri_b32").config
    gen_cfg = c["generator"]
    input_dim = 16 + 1 + 3
    frames = 7
    convs = list(counts.hifigan_convs(gen_cfg, input_dim, frames))
    model = ref_anon.CoreHifiGan(ref_anon.CoreHifiGanConfig(
        input_dim=input_dim, upsample_initial_channel=gen_cfg["upsample_initial_channel"]))
    with torch.no_grad():
        out = model(torch.zeros(1, input_dim, frames))
    assert out.shape[-1] == convs[-1][3] == frames * 320 + 1
    c0 = gen_cfg["upsample_initial_channel"]
    assert convs[0] == (input_dim, c0, 7, frames)
    assert convs[1] == (c0, c0 // 2, 11, frames)
    assert len(convs) == 1 + 5 * (1 + 3 * 6) + 1
