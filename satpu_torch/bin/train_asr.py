"""LF-MMI (chain) training of the TDNN-F ASR-BN extractor (port of
``satpu.bin.train_asr``).

Trains ``tdnnf`` or ``tdnnf_vq`` on one device (``--device``, CUDA unless
``--device cpu``): natural-gradient preconditioning on by default, an
exponential learning-rate decay from ``lr_initial`` to ``lr_final``,
gradient accumulation, resume from the latest trainer checkpoint, periodic
diagnostics (and a valid-set objf when ``valid_set``/``valid_fst_scp`` are
given), warm start from ``init_weight_model``, and the final combination
(the best-valid average of the last checkpoints). Checkpoints
``<steps>.ckpt`` / ``final.ckpt`` are ``asrbn_tdnnf`` models that
``satpu_torch.infer_helper.load_model`` serves; ``trainer_<steps>.ckpt``
holds the optimizer and natural-gradient states.

Inputs: wav.scp + utt2len in ``train_set``, per-utterance numerator FSTs
(``fst_scp``), the den graph (``den_fst``) and ``num_pdfs``.

Not ported yet (they raise NotImplementedError): the dp / spkadv / wav2vec2
models, the bf16 training policy and transition-id graphs (ROADMAP Queue 1,
item 11), waveform augmentation (item 13). Multi-device data parallelism
(item 15) is not ported: one process trains on one device.

Usage (from the repository root):
  python -m satpu_torch.bin.train_asr --config egs/asr/librispeech/configs/tdnnf_vq_48.ini
  python -m satpu_torch.bin.train_asr --train-set data/x --fst-scp ... --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import sys
from typing import Optional

from ..utils import checkpoint as ckpt
from ..utils import config as cfg


@dataclasses.dataclass
class TrainAsrOpts(cfg.Opts):
    dirname: str = "exp/chain"
    train_set: str = ""  # data dir containing wav.scp/utt2len
    valid_set: str = ""  # optional held-out data dir (wav.scp/utt2len)
    fst_scp: str = ""  # numerator fsts
    valid_fst_scp: str = ""
    den_fst: str = ""
    normalization_fst: str = ""
    trans_mdl: str = ""
    num_pdfs: int = 0
    model: str = "tdnnf"  # tdnnf | tdnnf_vq
    hidden_dim: int = 1024
    bottleneck_dim: int = 128
    prefinal_bottleneck_dim: int = 256
    codebook_size: int = 0
    minibatch_size: int = 16
    num_epochs: int = 5
    lr_initial: float = 0.001
    lr_final: float = 0.0001
    natural_gradient: bool = True
    grad_acc_steps: int = 1
    xent_regularize: float = 0.025
    l2_regularize: float = 1e-4
    leaky_hmm_coefficient: float = 1e-5
    checkpoint_interval: int = 100
    diagnostics_interval: int = 50
    final_combination_n: int = 5
    init_weight_model: str = ""
    compute_dtype: str = "float32"
    augmentation: str = ""
    device: str = "cuda"


_UNPORTED_MODELS = ("tdnnf_dp", "tdnnf_spkadv", "tdnnf_wav2vec2", "tdnnf_wav2vec2_vq",
                    "tdnnf_wav2vec2_dp")


def _check_supported(opts: TrainAsrOpts) -> None:
    if opts.model in _UNPORTED_MODELS:
        raise NotImplementedError(f"model {opts.model!r} is not ported yet: ROADMAP Queue 1,"
                                  " item 11 (the dp / spkadv / wav2vec2 variants)")
    if opts.model not in ("tdnnf", "tdnnf_vq"):
        raise ValueError(f"unknown model {opts.model!r}")
    if opts.compute_dtype != "float32":
        raise NotImplementedError("the bf16 training policy is not ported yet: ROADMAP"
                                  " Queue 1, item 11")
    if opts.augmentation:
        raise NotImplementedError("waveform augmentation (ops/augment.py) is not ported"
                                  " yet: ROADMAP Queue 1, item 13")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="")
    args, rest = parser.parse_known_args(argv)
    opts = TrainAsrOpts()
    if args.config:
        for sec, kv in cfg.load_ini(args.config).items():
            if sec != "var":
                opts.load_from_config(kv)
    opts.load_from_args(rest)
    _check_supported(opts)

    import torch

    from .. import infer_helper, resolve_device
    from ..chain.dataset import BucketBatchSampler, EgsDataset
    from ..chain.fst import Fst
    from ..chain.objf import DenominatorGraph
    from ..chain.trainer import ChainTrainer, ChainTrainOpts
    from ..models.asrbn import TDNNFNetConfig
    from ..utils.metrics import MetricsWriter

    dev = resolve_device(opts.device)
    os.makedirs(opts.dirname, exist_ok=True)
    den = DenominatorGraph.from_fst(Fst.read(opts.den_fst), num_pdfs=opts.num_pdfs)
    norm_fst = opts.normalization_fst or None
    ds = EgsDataset(os.path.join(opts.train_set, "wav.scp"), opts.fst_scp,
                    os.path.join(opts.train_set, "utt2len"), normalization_fst=norm_fst,
                    trans_mdl=opts.trans_mdl or None)
    removed = ds.filter_min_path()
    logging.info("egs: %d utts (%d removed by min-path check)", len(ds), removed)
    valid_ds = None
    if opts.valid_set and opts.valid_fst_scp:
        valid_ds = EgsDataset(os.path.join(opts.valid_set, "wav.scp"), opts.valid_fst_scp,
                              os.path.join(opts.valid_set, "utt2len"),
                              normalization_fst=norm_fst, trans_mdl=opts.trans_mdl or None)
        valid_ds.filter_min_path()

    mcfg = TDNNFNetConfig(output_dim=opts.num_pdfs,
                          bottleneck="vq" if opts.model == "tdnnf_vq" else "none",
                          hidden_dim=opts.hidden_dim, bottleneck_dim=opts.bottleneck_dim,
                          prefinal_bottleneck_dim=opts.prefinal_bottleneck_dim,
                          codebook_size=opts.codebook_size,
                          natural_gradient=opts.natural_gradient)
    build_params = dataclasses.asdict(mcfg)
    model = infer_helper.build_model("asrbn_tdnnf", device=dev, seed=0, **build_params)
    if opts.init_weight_model:
        _, loaded = ckpt.load_checkpoint(opts.init_weight_model)
        merged, matched, unmatched = ckpt.match_params(model.state_dict(), loaded)
        model.load_state_dict(merged)
        logging.info("init_weight_model %s: %d tensors transferred, %d skipped%s",
                     opts.init_weight_model, len(matched), len(unmatched),
                     f" ({', '.join(unmatched[:5])}...)" if unmatched else "")

    sampler = BucketBatchSampler(ds, opts.minibatch_size)
    total_steps = max(len(sampler), 1) * opts.num_epochs
    log_ratio = math.log(opts.lr_final / opts.lr_initial)

    def lr_at(step: int) -> float:
        """Exponential decay lr_initial -> lr_final over the run."""
        return opts.lr_initial * math.exp(min(step / float(total_steps), 1.0) * log_ratio)

    topts = ChainTrainOpts(lr=opts.lr_initial, xent_regularize=opts.xent_regularize,
                           l2_regularize=opts.l2_regularize,
                           leaky_hmm_coefficient=opts.leaky_hmm_coefficient)
    trainer = ChainTrainer(model, den, topts, grad_acc_steps=opts.grad_acc_steps,
                           lr_schedule=lr_at)

    def to_dev(wavs, graphs, frames):
        from ..chain.objf import graphs_to_torch

        return (torch.from_numpy(wavs).to(dev), graphs_to_torch(graphs, dev),
                torch.from_numpy(frames).to(dev))

    steps, start_epoch = 0, 0
    last = ckpt.latest_checkpoint(opts.dirname, "trainer_")
    if last:
        meta, tstate = ckpt.load_trainer_checkpoint(last)
        steps, start_epoch = int(meta["steps"]), int(meta["epoch"])
        _, mstate = ckpt.load_checkpoint(os.path.join(opts.dirname, f"{steps}.ckpt"))
        model.load_state_dict(mstate)
        trainer.load_state_dict(tstate)
        logging.info("resuming from %s (epoch %d, step %d)", last, start_epoch, steps)

    def save(epoch: int, final: bool = False) -> None:
        name = "final.ckpt" if final else f"{steps}.ckpt"
        infer_helper.save_model(os.path.join(opts.dirname, name), "asrbn_tdnnf",
                                build_params, model.state_dict(), extra_meta={"steps": steps})
        if not final:
            ckpt.save_trainer_checkpoint(
                os.path.join(opts.dirname, f"trainer_{steps}.ckpt"),
                {"steps": steps, "epoch": epoch}, trainer.state_dict())
        for prefix in ("", "trainer_"):
            ckpt.checkpoint_gc(opts.dirname, prefix, keep_last=10)

    def valid_objf() -> Optional[float]:
        return compute_valid_objf(model, den, valid_ds, opts.minibatch_size, topts, to_dev)

    with MetricsWriter(opts.dirname) as metrics_log:
        for epoch in range(start_epoch, opts.num_epochs):
            sampler.set_epoch(epoch)
            for batch_idx in sampler:
                wavs, graphs, frames, _ = ds.load_batch(batch_idx)
                metrics = trainer.step(*to_dev(wavs, graphs, frames))
                steps += 1
                if steps % opts.diagnostics_interval == 0:
                    scal = {k: float(v) for k, v in metrics.items()}
                    logging.info("epoch %d step %d objf %.4f (num %.3f den %.3f) lr %.5f",
                                 epoch, steps, scal["chain_objf"], scal["num_logprob"],
                                 scal["den_logprob"], scal["lr"])
                    if valid_ds is not None:
                        v = valid_objf()
                        if v is not None:
                            scal["valid_objf"] = v
                            logging.info("  valid objf %.4f", v)
                    metrics_log.write(steps, scal, epoch=epoch)
                if steps % opts.checkpoint_interval == 0:
                    save(epoch)
            save(epoch + 1)
        final_combination(opts, model, valid_ds, valid_objf)
        save(opts.num_epochs, final=True)
    return 0


def compute_valid_objf(model, den, valid_ds, minibatch_size, topts, to_dev,
                       max_batches: int = 8) -> Optional[float]:
    """Chain objf over up to ``max_batches`` valid batches, weighted by
    batch size, the network in eval mode."""
    from ..chain.dataset import BucketBatchSampler
    from ..chain.trainer import chain_valid_metrics

    vals, weights = [], []
    for bi, batch_idx in enumerate(BucketBatchSampler(valid_ds, minibatch_size)):
        if bi >= max_batches:
            break
        m = chain_valid_metrics(model, den, *to_dev(*valid_ds.load_batch(batch_idx)[:3]),
                                opts=topts)
        vals.append(float(m["chain_objf"]))
        weights.append(len(batch_idx))
    if not vals:
        return None
    return sum(v * w for v, w in zip(vals, weights)) / sum(weights)


def final_combination(opts, model, valid_ds, valid_objf) -> None:
    """Average the parameters of the last n checkpoints for n = 1..N and
    keep the average with the best valid objf (in place on ``model``)."""
    from ..chain.trainer import merge_models

    if valid_ds is None or opts.final_combination_n <= 1:
        return
    cands = ckpt.tagged_checkpoints(opts.dirname, "", ".ckpt")[-opts.final_combination_n:]
    if len(cands) < 2:
        return
    params = {name for name, _ in model.named_parameters()}
    trees = [{k: v for k, v in ckpt.load_checkpoint(os.path.join(opts.dirname, name))[1].items()
              if k in params} for _, name in cands]
    current = {k: v.detach().clone() for k, v in model.state_dict().items()}
    best_v, best = None, None
    for n in range(1, len(trees) + 1):
        avg = merge_models(trees[-n:])
        model.load_state_dict({**current, **avg})
        v = valid_objf()
        logging.info("final_combination: last %d ckpts -> valid objf %s", n, v)
        if v is not None and (best_v is None or v > best_v):
            best_v, best = v, avg
    model.load_state_dict({**current, **(best or {})})


if __name__ == "__main__":
    sys.exit(main())
