"""Data-parallel runs of the port's trainers for the tests, on the CPU over
gloo: ``spawn(case, world, workdir)`` starts ``world`` processes of this
file (each joins a gloo group on a free port, takes its contiguous block of
the global batches in ``workdir/inputs.pt``, runs ``CASES[case]`` and saves
its result to ``workdir/out_<rank>.pt``); the same case function called in
the test's own process, with no group, is the one-process run on the global
batches. Every process has the caller's time limit and is killed at it."""
import os
import socket
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(case: str, world: int, workdir: str, timeout: float = 120.0):
    """Run ``case`` in ``world`` gloo ranks; returns each rank's result."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), str(port), workdir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" + "\n".join(logs)
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def block(x, rank, world):
    """Rows [r B/n, (r+1) B/n) of x (an array, tensor or dict of them)."""
    from satpu_torch.parallel.mesh import local_batch_slice

    if isinstance(x, dict):
        return {k: block(v, rank, world) for k, v in x.items()}
    return x[local_batch_slice(len(x), rank, world)]


def run_chain(inp, rank=0, world=1):
    """The chain trainer (TDNN-F + VQ, NG on, in ``inp["dtype"]``) for one
    step per global batch: the loss and metrics of each step, the first
    step's gradients after NG, the final state and NG states."""
    from satpu_torch.chain.objf import DenominatorGraph, graphs_to_torch
    from satpu_torch.chain.prep import random_bigram_den
    from satpu_torch.chain.trainer import ChainTrainer
    from satpu_torch.models.asrbn import TDNNFNet, TDNNFNetConfig

    torch.set_num_threads(1)
    dtype = inp["dtype"]
    net = TDNNFNet(TDNNFNetConfig(**inp["cfg"])).to(dtype)
    net.load_state_dict(inp["state"])
    den = DenominatorGraph.from_fst(random_bigram_den(5, 3, seed=2)[0], inp["cfg"]["output_dim"])
    tr = ChainTrainer(net, den, ng_states=inp["ng_states"], lr_schedule=lambda s: 1e-3)
    out = {"loss": [], "metrics": []}
    for k, (wav, graphs, frames) in enumerate(inp["batches"]):
        lr = tr.lr_now()
        loss, m = tr.compute_grads(torch.from_numpy(block(wav, rank, world)),
                                   graphs_to_torch(block(graphs, rank, world), "cpu"),
                                   torch.from_numpy(block(frames, rank, world)))
        if k == 0:
            out["grads"] = {n: p.grad.clone() for n, p in net.named_parameters()}
        tr.apply_grads(lr)
        tr.step_count += 1
        out["loss"].append(loss.item())
        out["metrics"].append({n: v.item() for n, v in m.items()})
    out["state"] = {k: v.clone() for k, v in net.state_dict().items()}
    out["ng_states"] = tr.ng_states
    return out


def run_asv(inp, rank=0, world=1):
    """The ASV trainer (a tiny ECAPA, SpecAugment on, in ``inp["dtype"]``)
    for one step per global batch; with ``inp["feats"]`` the trunk reads
    those features (one array per batch) in place of its frontend's."""
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector

    torch.set_num_threads(1)
    model = build_xvector(XVectorConfig(**inp["cfg"])).to(inp["dtype"])
    model.load_state_dict(inp["state"])
    feats = iter(inp.get("feats") or ())
    if inp.get("feats"):
        model.features = lambda w, generator=None: torch.from_numpy(
            block(next(feats), rank, world))
    trainer = AsvTrainer(model, make_asv_optimizer(model, lr=inp["lr"]))
    gen = torch.Generator().manual_seed(5)
    out = {"loss": [], "accuracy": []}
    for wav, spk in inp["batches"]:
        m = trainer.train_step(torch.from_numpy(block(wav, rank, world)).to(inp["dtype"]),
                               torch.from_numpy(block(spk, rank, world)).long(), gen)
        out["loss"].append(m["loss"].item())
        out["accuracy"].append(m["accuracy"].item())
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def run_gan(inp, rank=0, world=1):
    """The GAN trainer (tiny generator and discriminators, in
    ``inp["dtype"]``) for one step per global batch."""
    import functools

    from satpu_torch.hifigan import trainer as gan
    from satpu_torch.models.anonymizer import AnonymizationNet, AnonymizerConfig

    torch.set_num_threads(1)
    model = AnonymizationNet(AnonymizerConfig(**inp["cfg"])).to(inp["dtype"])
    model.load_state_dict(inp["state"])
    h = functools.partial(gan.GanHparams, **inp["hparams"])()
    tr = gan.GanTrainer(model, h)
    tr.mpd.to(inp["dtype"]), tr.msd.to(inp["dtype"])
    tr.load_discriminator_state_dict(inp["disc"])
    out = {"metrics": []}
    for batch in inp["batches"]:
        m = tr.train_step({k: torch.from_numpy(block(v, rank, world)) for k, v in batch.items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["disc"] = {k: v.clone() for k, v in tr.discriminator_state_dict().items()}
    return out


def run_bn(inp, rank=0, world=1):
    """The ASV batch norm (``sidekit.nn.BatchNorm``, in ``x``'s dtype) in
    training on this rank's block of ``inp["x"]`` [B, C, T], backward from
    ``inp["g"]``: the output and input gradient blocks, this rank's
    weight / bias gradients, the running statistics."""
    from satpu_torch.sidekit.nn import BatchNorm

    torch.set_num_threads(1)
    x = torch.from_numpy(block(inp["x"], rank, world)).requires_grad_(True)
    bn = BatchNorm(x.shape[1]).to(x.dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["weight"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
    y = bn(x)
    y.backward(torch.from_numpy(block(inp["g"], rank, world)))
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


CASES = {"chain": run_chain, "asv": run_asv, "gan": run_gan, "bn": run_bn}


def main(case, rank, world, port, workdir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        out = [CASES[case](run, rank, world) for run in inp]
        torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
