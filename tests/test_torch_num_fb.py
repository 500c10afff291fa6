"""The numerator forward-backward (kernels K3f/K3b) and its plain versions.

On the CPU: the plain forward and backward against the per-frame loop the
objective ran before them and its autograd, bit for bit; the kernels'
grouping of the arcs (``num_arcs``) and their order of every sum, run in
PyTorch against the plain version, bit for bit; ``chain_objf_and_grad``
(one numerator call, its posteriors the xent targets) against the two-pass
objective; the wrappers' refusals. On the card: K3f/K3b against the plain
version over ragged ``num_frames``, padding arcs, unreachable states,
optional silence, T from 1 to 661 and graphs at the kernels' limits, two
calls bitwise equal, and the launches a call.

jax is not imported, so the card tests also run where it is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_num_fb.py``."""
import numpy as np
import pytest
import torch

from satpu_torch.chain import num_fb
from satpu_torch.chain.den_fb import NEG_INF, TINY
from satpu_torch.chain.fst import GraphArrays, fst_rmepsilon, fst_to_arrays, pad_graph_arrays
from satpu_torch.chain.objf import (DenominatorGraph, chain_objf_and_grad, compute_chain_objf,
                                    den_forward, graphs_to_torch)
from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk
from satpu_torch.utils import cuda_build
from satpu_torch.utils.trace import counters

KINDS = ("walks", "optional_sil", "unreachable")


def _launches():
    """(K3f, K3b) launches counted so far (``utils.trace``'s counters)."""
    c = counters()
    return c.get("k3f.launches", 0), c.get("k3b.launches", 0)


def _loop_step(alpha, arc_score_t, src, dst):
    scores = alpha.gather(-1, src) + arc_score_t
    m = scores.amax(dim=-1, keepdim=True).detach()
    m = torch.where(m > NEG_INF / 2, m, torch.zeros_like(m))
    sums = torch.zeros_like(alpha).scatter_add(-1, dst, torch.exp(scores - m))
    return torch.clamp(torch.log(torch.clamp(sums, min=TINY)) + m, min=NEG_INF)


def _loop(loglikes, g, num_frames=None):
    """The numerator as the objective computed it before K3: a per-frame
    loop, differentiated by autograd."""
    src, dst, pdf = g["arc_src"], g["arc_dst"], g["arc_pdf"]
    B, T, _ = loglikes.shape
    E = pdf.shape[-1]
    arc_scores = (loglikes.gather(-1, pdf[:, None, :].expand(B, T, E))
                  + g["arc_logprob"][:, None, :])
    alpha = torch.clamp(g["start_logprob"], min=NEG_INF)
    for t in range(T):
        new_alpha = _loop_step(alpha, arc_scores[:, t], src, dst)
        if num_frames is not None:
            new_alpha = torch.where((t < num_frames)[:, None], new_alpha, alpha)
        alpha = new_alpha
    return torch.logsumexp(torch.clamp(alpha + g["final_logprob"], min=NEG_INF), dim=-1)


def _with_unreachable(g: GraphArrays, rng) -> GraphArrays:
    """g with two more states: one no arc enters, one entered only by its
    own self-loop; both lead into the graph."""
    S = g.num_states
    extra_src = np.array([S, S, S + 1, S + 1], np.int32)
    extra_dst = np.array([1 % S, S + 1, S + 1, 0], np.int32)
    pdf = rng.integers(0, int(g.arc_pdf.max()) + 1, 4).astype(np.int32)
    return GraphArrays(S + 2, np.concatenate([g.arc_src, extra_src]),
                       np.concatenate([g.arc_dst, extra_dst]),
                       np.concatenate([g.arc_pdf, pdf]),
                       np.concatenate([g.arc_logprob, np.full(4, -0.7, np.float32)]),
                       np.concatenate([g.start_logprob, np.full(2, NEG_INF, np.float32)]),
                       np.concatenate([g.final_logprob, np.full(2, 0.3, np.float32)]))


def _graphs(kind: str, B: int, T: int, seed: int, phones=164, succ=9):
    """(graphs on the CPU, num_pdfs): B numerators of random phone walks of
    the den graph's bigram, about T / 3 phones and ragged (so rows carry
    padding arcs and padding states), as the chain cell makes them; with
    optional silence, or with unreachable states."""
    _, tree, trans = random_bigram_den(phones, succ, seed=0)
    rng = np.random.default_rng(seed)
    arrays = []
    for b in range(B):
        n = max(1, T // 3 - b % 3)
        fst = numerator_fst(random_phone_walk(trans, n, rng), tree,
                            optional_sil=1 if kind == "optional_sil" else None)
        g = fst_to_arrays(fst_rmepsilon(fst))
        arrays.append(_with_unreachable(g, rng) if kind == "unreachable" else g)
    return graphs_to_torch(pad_graph_arrays(arrays), "cpu"), tree.num_pdfs


def _inputs(kind, B, T, seed, ragged: bool):
    g, P = _graphs(kind, B, T, seed)
    rng = np.random.default_rng(seed + 1)
    ll = torch.from_numpy((rng.standard_normal((B, T, P)) * 2).astype(np.float32))
    frames = None
    if ragged:
        frames = torch.from_numpy(np.maximum(T - rng.integers(0, max(T // 2, 1), B), 0))
        frames[0] = T
    return ll, g, frames


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_equal_the_loop_and_its_autograd(kind, ragged):
    """num_fb_forward_plain's value is the loop's bits, and
    num_fb_backward_plain's posteriors autograd's of the loop; the alphas
    start at the clamped start and repeat on identity frames."""
    ll, g, frames = _inputs(kind, 4, 40, seed=3, ragged=ragged)
    x = ll.clone().requires_grad_(True)
    want = _loop(x, g, frames)
    want_posts, = torch.autograd.grad(want.sum(), x)
    value, alphas, m = num_fb.num_fb_forward_plain(ll, g, frames)
    posts = num_fb.num_fb_backward_plain(ll, g, frames)
    assert torch.equal(value, want.detach())
    assert torch.equal(posts, want_posts)
    assert torch.equal(alphas[:, 0], torch.clamp(g["start_logprob"], min=NEG_INF))
    assert tuple(m.shape) == (4, 40) and bool(torch.isfinite(posts).all())
    if ragged:
        n = int(frames[1])
        assert bool((alphas[1, n:] == alphas[1, n]).all()) and bool((m[1, n:] == 0).all())
        assert bool((posts[1, n:] == 0).all())
    # every live frame's numerator posteriors sum to one
    occupied = posts.sum(-1)
    live = torch.ones_like(occupied, dtype=torch.bool) if frames is None else (
        torch.arange(40)[None] < frames[:, None])
    assert torch.allclose(occupied[live], torch.ones(()), atol=1e-4)


def _kernel_order(ll, g, frames, arcs: num_fb.NumArcs):
    """The kernels' arithmetic in their order, in PyTorch and numpy f32
    scalars: each destination's sums over ``arcs``' in-arcs, each source's
    gradient over its out-arcs and each pdf's posterior over its arcs, one
    after another in the stored order; the per-arc exp / log / division are
    the plain version's elementwise ops. Returns (value, alphas, posts)."""
    B, T, P = ll.shape
    S = g["start_logprob"].shape[-1]
    f32 = np.float32
    alphas = torch.empty(B, T + 1, S)
    posts = torch.zeros(B, T, P)
    value = torch.empty(B)
    for b in range(B):
        L = int(arcs.in_ptr[b, S])
        src, pdf = arcs.src[b, :L].long(), arcs.pdf[b, :L].long()
        w = arcs.w[b, :L]
        ip, op = arcs.in_ptr[b].tolist(), arcs.out_ptr[b].tolist()
        out_pos, p_pos, p_pdf = (x[b, :L].tolist() for x in (arcs.out_pos, arcs.p_pos,
                                                              arcs.p_pdf))
        nf = T if frames is None else min(max(int(frames[b]), 0), T)
        alpha = torch.clamp(g["start_logprob"][b], min=NEG_INF)
        alphas[b, 0] = alpha
        saved = []
        for t in range(nf):
            score = alpha[src] + (ll[b, t, pdf] + w)
            mx = float(score.max()) if L else -np.inf
            m = torch.tensor(mx if mx > NEG_INF / 2 else 0.0)
            r = torch.exp(score - m).numpy()
            sums = np.zeros(S, f32)
            for j in range(S):
                acc = f32(0)
                for p in range(ip[j], ip[j + 1]):
                    acc = f32(acc + r[p])
                sums[j] = acc
            sums = torch.from_numpy(sums)
            x = torch.log(torch.clamp(sums, min=TINY)) + m
            saved.append((torch.from_numpy(r), sums, x))
            alpha = torch.clamp(x, min=NEG_INF)
            alphas[b, t + 1] = alpha
        alphas[b, nf + 1:] = alpha
        y = torch.clamp(alpha + g["final_logprob"][b], min=NEG_INF)
        value[b] = torch.logsumexp(y, -1)
        xT = alpha + g["final_logprob"][b]
        grad = torch.where(xT >= NEG_INF, torch.exp(y - value[b]), torch.zeros(()))
        for t in range(nf - 1, -1, -1):
            r, sums, x = saved[t]
            g1 = torch.where(x >= NEG_INF, grad, torch.zeros(()))
            g3 = torch.where(sums >= TINY, g1 / torch.clamp(sums, min=TINY), torch.zeros(()))
            dst_of = torch.repeat_interleave(torch.arange(S), torch.diff(arcs.in_ptr[b].long()))
            gs = (g3[dst_of] * r).numpy()
            new = np.zeros(S, f32)
            for j in range(S):
                acc = f32(0)
                for k in range(op[j], op[j + 1]):
                    acc = f32(acc + gs[out_pos[k]])
                new[j] = acc
            grad = torch.from_numpy(new)
            k = 0
            while k < L:
                acc, q = f32(0), k
                while q < L and p_pdf[q] == p_pdf[k]:
                    acc = f32(acc + gs[p_pos[q]])
                    q += 1
                posts[b, t, p_pdf[k]] = float(acc)
                k = q
    return value, alphas, posts


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_order_equals_the_plain_version(kind):
    """The sums in the kernels' order over num_arcs' groups give the plain
    version's bits: alphas, value and posteriors (rows with padding arcs
    and states, ragged num_frames, a row of no frames)."""
    ll, g, frames = _inputs(kind, 3, 12, seed=5, ragged=True)
    frames[2] = 0
    arcs = num_fb.num_arcs(g, ll.shape[-1])
    value, alphas, posts = _kernel_order(ll, g, frames, arcs)
    want_v, want_a, _ = num_fb.num_fb_forward_plain(ll, g, frames)
    want_p = num_fb.num_fb_backward_plain(ll, g, frames)
    assert torch.equal(alphas, want_a)
    assert torch.equal(value, want_v)
    assert torch.equal(posts, want_p)


@pytest.mark.parametrize("kind", KINDS)
def test_num_arcs_groups_every_live_arc_once_in_arc_order(kind):
    """num_arcs: the live arcs (padding left out) by destination, by source
    and by pdf, each group in the original arc order, int32 throughout."""
    ll, g, _ = _inputs(kind, 4, 30, seed=7, ragged=False)
    P = ll.shape[-1]
    S, E = g["start_logprob"].shape[-1], g["arc_src"].shape[-1]
    arcs = num_fb.num_arcs(g, P)
    assert [x.dtype for x in arcs] == [torch.int32] * 2 + [torch.float32] + [torch.int32] * 5
    assert [tuple(x.shape) for x in arcs] == [(4, E)] * 3 + [(4, S + 1)] * 2 + [(4, E)] * 3
    live = g["arc_logprob"] > NEG_INF / 2
    for b in range(4):
        orig = torch.nonzero(live[b]).flatten()  # live arcs, original order
        L = int(arcs.in_ptr[b, S])
        assert L == len(orig) == int(arcs.out_ptr[b, S])
        dst_sorted = g["arc_dst"][b, orig]
        # by destination: stable, so in arc order within each destination
        by_dst = orig[torch.sort(dst_sorted, stable=True).indices]
        assert torch.equal(arcs.src[b, :L].long(), g["arc_src"][b, by_dst])
        assert torch.equal(arcs.pdf[b, :L].long(), g["arc_pdf"][b, by_dst])
        assert torch.equal(arcs.w[b, :L], g["arc_logprob"][b, by_dst])
        counts = torch.bincount(dst_sorted, minlength=S)
        assert torch.equal(torch.diff(arcs.in_ptr[b].long()), counts)
        by_src = orig[torch.sort(g["arc_src"][b, orig], stable=True).indices]
        assert torch.equal(by_dst[arcs.out_pos[b, :L].long()], by_src)
        assert torch.equal(torch.diff(arcs.out_ptr[b].long()),
                           torch.bincount(g["arc_src"][b, orig], minlength=S))
        by_pdf = orig[torch.sort(g["arc_pdf"][b, orig], stable=True).indices]
        assert torch.equal(by_dst[arcs.p_pos[b, :L].long()], by_pdf)
        assert torch.equal(arcs.p_pdf[b, :L].long(), g["arc_pdf"][b, by_pdf])


def _den():
    fst, tree, _ = random_bigram_den(164, 9, seed=0)
    return DenominatorGraph.from_fst(fst, tree.num_pdfs)


def _two_pass(co, xo, g, den, frames, xent_regularize=0.025, l2_regularize=1e-4):
    """The objective as it was before K3: the numerator by the loop, the
    xent targets from a second loop and its autograd."""
    tot = frames.sum().to(torch.float32)
    num_ll = _loop(co, g, frames)
    den_ll = den_forward(co, den, 1e-5)
    objf = torch.sum(num_ll - den_ll)
    l2 = torch.sum(co ** 2) / tot
    loss = -objf / tot + 0.5 * l2_regularize * l2
    with torch.enable_grad():
        ll = co.detach().requires_grad_(True)
        posts, = torch.autograd.grad(_loop(ll, g, frames).sum(), ll)
    xent_objf = torch.sum(posts * xo) / tot
    return loss - xent_regularize * xent_objf, xent_objf


def test_chain_objf_and_grad_equals_the_two_pass_objective():
    """One numerator call: the loss and the xent objective are the two-pass
    objective's bits, the xent output's gradient too; the chain output's
    gradient (the posteriors scaled once, not carried through the
    recursion) within 1e-6 of its largest entry. Launches nothing here."""
    B, T = 3, 36
    ll, g, frames = _inputs("walks", B, T, seed=9, ragged=True)
    den = _den()
    rng = np.random.default_rng(10)
    xent = torch.log_softmax(torch.from_numpy(rng.standard_normal(ll.shape).astype(np.float32)),
                             -1)
    got, want = [], []
    n = _launches()
    for fn, out in ((chain_objf_and_grad, got), (_two_pass, want)):
        co, xo = ll.clone().requires_grad_(True), xent.clone().requires_grad_(True)
        if fn is chain_objf_and_grad:
            loss, metrics = fn(co, xo, g, den, num_frames=frames)
            xent_objf = metrics["xent_objf"]
        else:
            loss, xent_objf = fn(co, xo, g, den, frames)
        loss.backward()
        out += [loss.detach(), xent_objf.detach(), co.grad, xo.grad]
    assert _launches() == n
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[3], want[3])
    scale = want[2].abs().max()
    assert float((got[2] - want[2]).abs().max() / scale) <= 1e-6


def test_no_grad_skips_the_posteriors_and_compute_chain_objf_matches():
    """Under no_grad without the xent targets num_fb returns no posteriors;
    compute_chain_objf is (num - den) per frame by the loop's numerator."""
    ll, g, frames = _inputs("walks", 2, 24, seed=11, ragged=True)
    den = _den()
    with torch.no_grad():
        value, posts = num_fb.num_fb(ll, g, frames)
        got = compute_chain_objf(ll, g, den, frames)
        want = torch.sum(_loop(ll, g, frames) - den_forward(ll, den, 1e-5)) / frames.sum()
    assert posts is None and torch.equal(value, _loop(ll, g, frames))
    assert torch.equal(got, want)


def test_wrappers_refuse_bad_inputs():
    ll, g, frames = _inputs("walks", 2, 10, seed=13, ragged=True)
    with pytest.raises(TypeError, match="float32"):
        num_fb.num_fb_forward(ll.double(), g, frames)
    with pytest.raises(TypeError, match="arc_logprob must be float32"):
        num_fb.num_fb_forward(ll, {**g, "arc_logprob": g["arc_logprob"].double()}, frames)
    with pytest.raises(TypeError, match="arc_src must be integer"):
        num_fb.num_fb_forward(ll, {**g, "arc_src": g["arc_src"].float()}, frames)
    with pytest.raises(ValueError, match=r"\[B, T, P\]"):
        num_fb.num_fb_forward(ll[0], g, frames)
    with pytest.raises(ValueError, match="arc_dst must be"):
        num_fb.num_fb_forward(ll, {**g, "arc_dst": g["arc_dst"][:, :-1]}, frames)
    with pytest.raises(ValueError, match="final_logprob must be"):
        num_fb.num_fb_forward(ll, {**g, "final_logprob": g["final_logprob"][:1]}, frames)
    with pytest.raises(ValueError, match="lack"):
        num_fb.num_fb_forward(ll, {k: v for k, v in g.items() if k != "arc_pdf"}, frames)
    with pytest.raises(ValueError, match="num_frames"):
        num_fb.num_fb_forward(ll, g, frames[:1])
    value, alphas, m = num_fb.num_fb_forward(ll, g, frames)
    with pytest.raises(ValueError, match="do not match"):
        num_fb.num_fb_backward(ll, g, frames, alphas[:, :-1], m, value)


# ---- on the card ----------------------------------------------------------

def _cuda(g):
    return {k: v.cuda() for k, v in g.items()}


def _card_check(ll, g, frames):
    """K3f/K3b (through num_fb_forward / num_fb_backward) against the plain
    version on the card: value rel <= 1e-6, alphas where live, posteriors
    max abs <= 1e-5, two calls bitwise equal, one launch each."""
    n = _launches()
    runs = []
    for _ in range(2):
        v, a, m = num_fb.num_fb_forward(ll, g, frames)
        runs.append((v, a, m, num_fb.num_fb_backward(ll, g, frames, a, m, v)))
    torch.cuda.synchronize()
    assert _launches() == (n[0] + 2, n[1] + 2)
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    v, a, _, posts = runs[0]
    v_p, a_p, _ = num_fb.num_fb_forward_plain(ll, g, frames)
    posts_p = num_fb.num_fb_backward_plain(ll, g, frames)
    assert bool(torch.isfinite(v).all() and torch.isfinite(posts).all())
    assert float((v - v_p).abs().max() / v_p.abs().max()) <= 1e-6
    live = a_p > NEG_INF / 2
    assert float((a - a_p)[live].abs().max() / a_p[live].abs().max()) <= 1e-6
    assert float((posts - posts_p).abs().max()) <= 1e-5
    return v, posts


@pytest.mark.gpu
@pytest.mark.parametrize("case", [("walks", 16, 661, False), ("walks", 16, 247, True),
                                  ("walks", 3, 1, False), ("walks", 5, 2, True),
                                  ("optional_sil", 4, 200, True),
                                  ("unreachable", 3, 50, True)])
def test_num_cuda_kernels_match_plain(case):
    """K3f/K3b against the plain version on the card: the chain cell's
    shapes (B=16, T = 661 and 247, its graphs), T = 1 and 2, ragged
    num_frames (padding arcs and states in every case), optional silence
    and unreachable states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the numerator kernels have no CPU mode")
    kind, B, T, ragged = case
    ll, g, frames = _inputs(kind, B, T, seed=17, ragged=ragged)
    _card_check(ll.cuda(), _cuda(g), None if frames is None else frames.cuda())


def _random_graph(S: int, E: int, P: int, rng):
    """A random graph of S states and E arcs (a chain from the start over up
    to E / 2 states, the rest random), start 0, every state final."""
    chain = np.arange(min(S - 1, E // 2))
    rest = E - len(chain)
    src = np.concatenate([chain, rng.integers(0, S, rest)]).astype(np.int32)
    dst = np.concatenate([chain + 1, rng.integers(0, S, rest)]).astype(np.int32)
    start = np.full(S, NEG_INF, np.float32)
    start[0] = 0.0
    return GraphArrays(S, src, dst, rng.integers(0, P, E).astype(np.int32),
                       rng.uniform(-3, 0, E).astype(np.float32), start,
                       np.zeros(S, np.float32))


@pytest.mark.gpu
def test_num_cuda_kernels_at_their_limits():
    """Graphs at the most the kernels take: S = 1024 states with the most
    arcs a block's shared memory holds beside them, and the most states
    with 1000 arcs (several states a thread); one arc or state more raises
    ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the numerator kernels have no CPU mode")
    lib = cuda_build.load("num_fb")
    fits = lambda S, E: max(lib.satpu_num_smem_bytes(S, E, 0),
                            lib.satpu_num_smem_bytes(S, E, 1)) <= cuda_build.SMEM_LIMIT
    P, rng = 3280, np.random.default_rng(19)
    E_max = max(E for E in range(1, 20000) if fits(1024, E))
    S_max = max(S for S in range(1000, 20000) if fits(S, 1000))
    for S, E, more in ((1024, E_max, (1024, E_max + 1)), (S_max, 1000, (S_max + 1, 1000))):
        g = _cuda(graphs_to_torch(pad_graph_arrays([_random_graph(S, E, P, rng)
                                                    for _ in range(2)]), "cpu"))
        ll = torch.randn(2, 20, P, device="cuda") * 2
        _card_check(ll, g, torch.tensor([20, 13], device="cuda"))
        big = _cuda(graphs_to_torch(pad_graph_arrays([_random_graph(*more, P, rng)]), "cpu"))
        with pytest.raises(ValueError, match="shared memory"):
            num_fb.num_fb_forward(ll[:1], big)


@pytest.mark.gpu
def test_num_cuda_launches_per_objective_call():
    """On the card chain_objf_and_grad launches K3f and K3b once each (its
    posteriors serve the xent targets and the gradient), compute_chain_objf
    under no_grad K3f alone; the loss and both gradients match the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the numerator kernels have no CPU mode")
    ll, g, frames = _inputs("walks", 4, 90, seed=23, ragged=True)
    den = _den()
    rng = np.random.default_rng(24)
    xent = torch.log_softmax(torch.from_numpy(rng.standard_normal(ll.shape).astype(np.float32)),
                             -1)
    outs = []
    for dev in ("cuda", "cpu"):
        co = ll.to(dev).requires_grad_(True)
        xo = xent.to(dev).requires_grad_(True)
        gd = {k: v.to(dev) for k, v in g.items()}
        n = _launches()
        loss, _ = chain_objf_and_grad(co, xo, gd, den, num_frames=frames.to(dev))
        loss.backward()
        if dev == "cuda":
            assert _launches() == (n[0] + 1, n[1] + 1)
            with torch.no_grad():
                compute_chain_objf(co, gd, den, frames.to(dev))
            assert _launches() == (n[0] + 2, n[1] + 1)
        outs.append([loss.detach().cpu(), co.grad.cpu(), xo.grad.cpu()])
    (loss, gc, gx), (loss_c, gc_c, gx_c) = outs
    assert abs(float(loss - loss_c)) <= 1e-5 * abs(float(loss_c))
    assert float((gc - gc_c).abs().max()) <= 1e-6 and float((gx - gx_c).abs().max()) <= 1e-6
