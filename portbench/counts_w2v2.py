"""Operations of the B5 extractor's train step and the bound of its attention,
counted from the published architecture (wav2vec 2.0 large, then the TDNN-F
stages of SA-toolkit's ``tdnnf_wav2vec2``), as ``counts`` counts the fbank
net's. A multiply-add counts as two operations; layer norms, GELUs and the
softmax's exponentials are not counted.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from portbench.counts import PEAK_FLOPS, _frames_out, _padding, bound_s
from portbench.reference.wav2vec2 import num_frames

# the fastest an attention accurate to float32 can run on the card: its
# products in TF32 on the tensor cores, three a multiply (a value split in
# a high and a low TF32 part), so a third of the TF32 peak
ATTENTION_PEAK = PEAK_FLOPS["tf32"] / 3


def front_frames(w2v2: Dict, num_samples: int) -> int:
    return num_frames(num_samples, w2v2["conv_kernel"], w2v2["conv_stride"])


def front_flops(w2v2: Dict, num_samples: int) -> float:
    """One utterance's forward through the front: the extractor's convs,
    the projection, the positional conv, and in each layer the four
    projections, q k^T and the probabilities times v (4 T'^2 d), and the FFN."""
    ops, t, c_in = 0.0, num_samples, 1
    for c, k, s in zip(w2v2["conv_dim"], w2v2["conv_kernel"], w2v2["conv_stride"]):
        t = (t - k) // s + 1
        ops += 2 * c_in * k * c * t
        c_in = c
    d, ff = w2v2["hidden_size"], w2v2["intermediate_size"]
    ops += 2 * c_in * d * t
    ops += 2 * (d // w2v2["num_conv_pos_embedding_groups"]) * w2v2["num_conv_pos_embeddings"] * d * t
    per_layer = 2 * 4 * d * d * t + 4 * t * t * d + 2 * 2 * d * ff * t
    return ops + w2v2["num_hidden_layers"] * per_layer


def tdnnf_affines(net: Dict, frames: int, dim: int) -> Iterator[Tuple[int, int, int]]:
    """(input width, output width, frames) of every affine of the TDNN-F
    stages and both heads over ``frames`` input frames of width ``dim``
    (the front's, with its repeated last frame)."""
    ks, ss = net["kernel_size_list"], net["subsampling_factor_list"]
    ksa, ssa = net["kernel_size_list_after"], net["subsampling_factor_list_after"]
    h, b, pb = net["hidden_dim"], net["bottleneck_dim"], net["prefinal_bottleneck_dim"]
    t = frames + 2 * (_padding(ks, ss) // 2)
    for i, (k, s) in enumerate(zip(ks, ss)):
        t = _frames_out(t, k, s, dim)
        last = i == len(ks) - 1
        yield dim * k, pb if last else b, t
        yield pb if last else b, h, t
        dim = h
    t += 2 * (_padding(ksa, ssa) // 2)
    for k, s in zip(ksa, ssa):
        t = _frames_out(t, k, s, h)
        yield h * k, b, t
        yield b, h, t
    for _ in range(2):  # the chain and xent prefinal layers and heads
        yield h, pb, t
        yield pb, h, t
        yield h, net["output_dim"], t


def net_flops(net: Dict, num_samples: int) -> float:
    """One utterance's forward: the front, the TDNN-F's affines and the VQ's
    distances at the bottleneck."""
    w2v2 = net["wav2vec2"]
    affines = list(tdnnf_affines(net, front_frames(w2v2, num_samples) + 1, w2v2["hidden_size"]))
    ops = front_flops(w2v2, num_samples) + sum(2 * i * o * t for i, o, t in affines)
    if net.get("bottleneck") == "vq":
        t_bn = affines[2 * len(net["kernel_size_list"]) - 1][2]
        ops += 2 * net["prefinal_bottleneck_dim"] * net["codebook_size"] * t_bn
    return ops


def train_step_flops(net: Dict, lengths: List[int]) -> float:
    """One training step's forward and backward (the backward twice the
    forward) over utterances of ``lengths`` samples."""
    return 3 * sum(net_flops(net, n) for n in lengths)


def attention_bound_s(w2v2: Dict, batch: int, num_samples: int) -> float:
    """The least time of one step's attention at every layer over a
    [batch, num_samples] batch: the forward's 4 B H T'^2 d_h operations (q k^T
    and the probabilities times v) and the backward's twice that (the
    gradients of both products with respect to both operands), at
    ``ATTENTION_PEAK``; or, where longer, their bytes at the memory rate: the
    forward reads q, k, v and writes the output and a log-sum-exp a row and
    head, the backward reads those and the output's gradient and writes the
    gradients of q, k and v, all in float32."""
    t = front_frames(w2v2, num_samples)
    d, h = w2v2["hidden_size"], w2v2["num_attention_heads"]
    act, lse = 4 * batch * t * d, 4 * batch * h * t
    fwd = bound_s(4 * batch * t * t * d, 4 * act + lse, ATTENTION_PEAK)
    bwd = bound_s(8 * batch * t * t * d, 8 * act + lse, ATTENTION_PEAK)
    return w2v2["num_hidden_layers"] * (fwd + bwd)
