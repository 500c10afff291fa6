"""The boundary between the port and its CUDA kernels
(``satpu_torch/utils/cuda_build.py``), on the CPU: the one device rule at
each of the six kernel entry points (K1 ``shc_band``, K4 ``viterbi_path``,
K2f/K2b ``den_fb_forward``/``den_fb_backward``, K3f/K3b
``num_fb_forward``/``num_fb_backward``), and the C signatures declared for
each ``csrc/*.cu`` against the sources' ``extern "C"`` entry points."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from satpu_torch.chain import den_fb, num_fb
from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
from satpu_torch.chain.objf import DenominatorGraph, graphs_to_torch
from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk
from satpu_torch.ops import yaapt as Y
from satpu_torch.utils import cuda_build

B, T = 2, 6


def _den_args():
    """(llf, lls, alpha0, A, log_self, log_init) of a 5-phone bigram den
    graph, on the CPU."""
    fst, tree, _ = random_bigram_den(5, 3, seed=2)
    den = DenominatorGraph.from_fst(fst, tree.num_pdfs)
    g = den.tensors("cpu")
    ll = torch.randn(B, T, tree.num_pdfs, generator=torch.Generator().manual_seed(0))
    return (ll.index_select(-1, g["pdf_fwd"]), ll.index_select(-1, g["pdf_self"]),
            g["start"].expand(B, den.num_states).contiguous(), g["A"], g["log_self"],
            g["log_init"])


def _num_args():
    """(loglikes, graphs, num_frames) of B random-walk numerators, on the CPU."""
    _, tree, trans = random_bigram_den(5, 3, seed=2)
    rng = np.random.default_rng(3)
    graphs = graphs_to_torch(pad_graph_arrays([
        fst_to_arrays(fst_rmepsilon(numerator_fst(random_phone_walk(trans, 2, rng), tree)))
        for _ in range(B)]), "cpu")
    ll = torch.from_numpy(rng.standard_normal((B, T, tree.num_pdfs)).astype(np.float32))
    return ll, graphs, torch.tensor([T, T - 2])


def _call(name: str):
    """(entry point, its arguments on CPU tensors)."""
    lk = den_fb.leak_log(1e-5)
    if name == "shc_band":
        return Y.shc_band, (torch.rand(3, 40), 2, 3, 3, 4)
    if name == "viterbi_path":
        return Y.viterbi_path, (torch.rand(B, 4, T), torch.rand(B, 4, 4, T))
    if name == "den_fb_forward":
        return den_fb.den_fb_forward, (*_den_args(), lk)
    if name == "den_fb_backward":
        llf, lls, a0, *graph = _den_args()
        alphas = den_fb.den_fb_forward_plain(llf, lls, a0, *graph, lk)
        return den_fb.den_fb_backward, (torch.ones_like(a0), alphas, llf, lls, *graph, lk)
    ll, graphs, frames = _num_args()
    if name == "num_fb_forward":
        return num_fb.num_fb_forward, (ll, graphs, frames)
    value, alphas, m = num_fb.num_fb_forward_plain(ll, graphs, frames)
    return num_fb.num_fb_backward, (ll, graphs, frames, alphas, m, value)


def _to_meta(args, which: str):
    """``args`` with every tensor (``which`` = "all", graphs' included) or
    only the last tensor argument ("last") moved to the meta device."""
    last = max(i for i, a in enumerate(args) if torch.is_tensor(a))

    def move(i, a):
        if isinstance(a, dict) and which == "all":
            return {k: v.to("meta") for k, v in a.items()}
        return a.to("meta") if torch.is_tensor(a) and (which == "all" or i == last) else a

    return tuple(move(i, a) for i, a in enumerate(args))


ENTRY_POINTS = ("shc_band", "viterbi_path", "den_fb_forward", "den_fb_backward",
                "num_fb_forward", "num_fb_backward")


# shc_band takes one tensor, so only the meta case
@pytest.mark.parametrize("name,case", [(n, c) for n in ENTRY_POINTS for c in ("meta", "mixed")
                                       if (n, c) != ("shc_band", "mixed")])
def test_entry_points_take_their_device_from_the_one_rule(name, case):
    """The call runs on CPU tensors; with a meta tensor, or with its last
    tensor on meta and the rest on the CPU, it raises the rule's ValueError
    before any check of its own."""
    fn, args = _call(name)
    fn(*args)
    match = ("runs on cpu or cuda, not meta" if case == "meta"
             else "inputs are on cpu and meta")
    with pytest.raises(ValueError, match=match):
        fn(*_to_meta(args, "all" if case == "meta" else "last"))


_C_ENTRY = re.compile(r'extern "C"\s+([\w ]+?)\s+(satpu_\w+)\s*\(([^)]*)\)')
_C_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_type(decl: str):
    """The ctypes type of a named C declaration ("long long l_b"), or
    "pointer"."""
    if "*" in decl:
        return "pointer"
    return _C_SCALARS[" ".join(decl.split()[:-1])]


@pytest.mark.parametrize("lib", sorted(cuda_build.SIGNATURES))
def test_signatures_match_the_c_sources(lib):
    """Every ``extern "C"`` entry point of ``csrc/<lib>.cu`` is declared,
    with its return type and each parameter's type (a pointer as a
    ``c_void_p`` or a typed pointer), and nothing else is."""
    with open(os.path.join(cuda_build.CSRC_DIR, lib + ".cu")) as f:
        entries = {m.group(2): m for m in _C_ENTRY.finditer(f.read())}
    declared = cuda_build.SIGNATURES[lib]
    assert set(entries) == set(declared)
    for symbol, (restype, argtypes) in declared.items():
        ret, _, params = entries[symbol].groups()
        assert _c_type(ret + " r") is restype, symbol
        want = [_c_type(p) for p in params.split(",") if p.strip()]
        assert len(want) == len(argtypes), symbol
        for w, got in zip(want, argtypes):
            if w == "pointer":
                assert got is ctypes.c_void_p or issubclass(got, ctypes._Pointer), symbol
            else:
                assert got is w, symbol
