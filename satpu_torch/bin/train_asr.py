"""LF-MMI (chain) training of the ASR-BN extractors (port of
``satpu.bin.train_asr``).

Trains on one device (``--device``, CUDA unless ``--device cpu``):

- ``tdnnf`` / ``tdnnf_vq`` / ``tdnnf_dp``: the fbank TDNN-F with no, a VQ
  (``codebook_size``) or a Laplace DP (``dp_epsilon``) bottleneck;
- ``tdnnf_spkadv``: the TDNN-F with a speaker-adversarial x-vector branch
  on its bottleneck (targets from the train set's utt2spk; ``adversarial``
  switches the gradient reversal, ``freeze_encoder`` is the train_asi
  phase: the trunk below the prefinal heads takes no update);
- ``tdnnf_wav2vec2`` / ``_vq`` / ``_dp``: the wav2vec2-fronted net
  (``wav2vec2_size`` large or base; random init, or a warm start from
  ``init_weight_model``), whose front's updates are scaled by 1/20 for the
  first 10% of the steps, 1/5 until 90% and 0 after.

Natural-gradient preconditioning is on by default; an exponential
learning-rate decay from ``lr_initial`` to ``lr_final``; gradient
accumulation; ``compute_dtype = bfloat16`` (satpu's bf16 training
policy); ``trans_mdl`` for numerator graphs labelled with transition ids;
resume from the latest trainer checkpoint; periodic diagnostics (and a
valid-set objf when ``valid_set``/``valid_fst_scp`` are given); the final
combination (the best-valid average of the last checkpoints).
Checkpoints ``<steps>.ckpt`` / ``final.ckpt`` carry satpu's ``model_id``
(``asrbn_tdnnf``, ``asrbn_tdnnf_spkadv`` with ``num_speakers`` and
``adversarial``, ``asrbn_tdnnf_wav2vec2`` with the ``wav2vec2`` config) and
load through ``satpu_torch.infer_helper.load_model``;
``trainer_<steps>.ckpt`` holds the optimizer and natural-gradient states.

Inputs: wav.scp + utt2len in ``train_set`` (and utt2spk for
``tdnnf_spkadv``), per-utterance numerator FSTs (``fst_scp``), the den graph
(``den_fst``) and ``num_pdfs``; ``satpu_torch.bin.prepare_data`` writes
them all from a kaldi data dir.

``augmentation`` (inline lenient JSON or a .json path, with its noise and
RIR databases; ``ops.augment.load_augmentation``) augments every eg of a
batch on the host.

Data parallelism (satpu's ``data`` mesh): under ``torchrun --nproc-per-node
N`` each rank drives ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device
cpu``). Every rank draws the same batch order, loads the global batch,
repeat-pads a short one to a multiple of N as satpu does, and trains on its
contiguous block; the step is the global batch's (``chain.trainer``).
``minibatch_size`` must be a multiple of N. Rank 0 alone writes the
checkpoints, ``metrics.jsonl`` and the logs.

Usage (from the repository root):
  python -m satpu_torch.bin.train_asr --config egs/asr/librispeech/configs/tdnnf_wav2vec2_vq_48.ini
  torchrun --nproc-per-node 2 -m satpu_torch.bin.train_asr --config ...
  python -m satpu_torch.bin.train_asr --train-set data/x --fst-scp ... --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
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
    # tdnnf | tdnnf_vq | tdnnf_dp | tdnnf_spkadv | tdnnf_wav2vec2[_vq|_dp]
    model: str = "tdnnf"
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
    train_stage: str = "0"  # accepted and ignored, as satpu does
    init_weight_model: str = ""
    compute_dtype: str = "float32"
    augmentation: str = ""
    # the variants' options: tdnnf_spkadv's train_asi phase and gradient
    # reversal, the DP bottleneck's Laplace epsilon, the wav2vec2 front's size
    # and its transformer layers (0: the size's own 24 or 12)
    freeze_encoder: bool = False
    adversarial: bool = True
    dp_epsilon: float = 0.0
    wav2vec2_size: str = "large"
    wav2vec2_layers: int = 0
    device: str = "cuda"


MODELS = ("tdnnf", "tdnnf_vq", "tdnnf_dp", "tdnnf_spkadv", "tdnnf_wav2vec2",
          "tdnnf_wav2vec2_vq", "tdnnf_wav2vec2_dp")
# tdnnf_spkadv's freeze_encoder: the heads that keep training (with the
# speaker branch); the rest of the acoustic trunk takes no update
TRAINABLE_HEADS = {"prefinal_chain", "prefinal_xent", "chain_output", "xent_output"}


def _check_supported(opts: TrainAsrOpts) -> None:
    if opts.freeze_encoder and opts.model != "tdnnf_spkadv":
        raise ValueError(
            "freeze_encoder is the spkadv train_asi phase and requires model = tdnnf_spkadv; "
            "for the wav2vec2 front use its built-in freeze schedule")
    if opts.model not in MODELS:
        raise ValueError(f"unknown model {opts.model!r}")
    if opts.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {opts.compute_dtype!r}")
    if opts.model.startswith("tdnnf_wav2vec2") and opts.wav2vec2_size not in ("large", "base"):
        raise ValueError(f"unknown wav2vec2_size {opts.wav2vec2_size!r}")


def wav2vec2_update_factor(step: int, total_steps: int) -> float:
    """The wav2vec2 front's update factor at ``step`` of ``total_steps``:
    1/20 for the first 10% of the steps, 1/5 until 90%, frozen after."""
    frac = step / float(total_steps)
    return 1.0 / 20.0 if frac < 0.1 else 1.0 / 5.0 if frac < 0.9 else 0.0


def build_params_for(opts: TrainAsrOpts, num_speakers: int = 0):
    """(model_id, build_params) of the model ``opts`` trains, as satpu's
    checkpoints write them."""
    from ..models.asrbn import TDNNFNetConfig, wav2vec2_tdnnf_config
    from ..models.wav2vec2 import Wav2Vec2Config

    widths = dict(hidden_dim=opts.hidden_dim, bottleneck_dim=opts.bottleneck_dim,
                  prefinal_bottleneck_dim=opts.prefinal_bottleneck_dim,
                  natural_gradient=opts.natural_gradient, compute_dtype=opts.compute_dtype)
    if opts.model.startswith("tdnnf_wav2vec2"):
        bottleneck = {"vq": "vq", "dp": "dp"}.get(opts.model.rsplit("_", 1)[-1], "none")
        mcfg = dataclasses.replace(
            wav2vec2_tdnnf_config(output_dim=opts.num_pdfs, bottleneck=bottleneck,
                                  codebook_size=opts.codebook_size, epsilon=opts.dp_epsilon),
            **widths)
        w2v2 = Wav2Vec2Config.large() if opts.wav2vec2_size == "large" else Wav2Vec2Config.base()
        if opts.wav2vec2_layers:
            w2v2 = dataclasses.replace(w2v2, num_hidden_layers=opts.wav2vec2_layers)
        return "asrbn_tdnnf_wav2vec2", dict(dataclasses.asdict(mcfg),
                                            wav2vec2=dataclasses.asdict(w2v2))
    bottleneck = {"tdnnf_vq": "vq", "tdnnf_dp": "dp"}.get(opts.model, "none")
    mcfg = TDNNFNetConfig(output_dim=opts.num_pdfs, bottleneck=bottleneck,
                          codebook_size=opts.codebook_size, epsilon=opts.dp_epsilon, **widths)
    if opts.model == "tdnnf_spkadv":
        return "asrbn_tdnnf_spkadv", dict(dataclasses.asdict(mcfg), num_speakers=num_speakers,
                                          adversarial=opts.adversarial)
    return "asrbn_tdnnf", dataclasses.asdict(mcfg)


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

    from .. import resolve_device
    from ..parallel import mesh, multihost

    mesh.check_batch_divisible(opts.minibatch_size, multihost.configured_world_size())
    with multihost.distributed(resolve_device(opts.device)):
        return _train(opts)


def _train(opts: TrainAsrOpts) -> int:
    import numpy as np
    import torch

    from .. import infer_helper, resolve_device
    from ..chain.dataset import BucketBatchSampler, EgsDataset, speaker_index
    from ..chain.fst import Fst
    from ..chain.objf import DenominatorGraph
    from ..chain.trainer import ChainTrainer, ChainTrainOpts
    from ..ops.augment import load_augmentation
    from ..parallel import mesh, multihost
    from ..utils.metrics import MetricsWriter

    dev = multihost.local_device(resolve_device(opts.device))
    world, rank = mesh.world(), mesh.rank()
    if rank:
        logging.getLogger().setLevel(logging.WARNING)
    os.makedirs(opts.dirname, exist_ok=True)
    den = DenominatorGraph.from_fst(Fst.read(opts.den_fst), num_pdfs=opts.num_pdfs)
    norm_fst = opts.normalization_fst or None
    aug, noise_db, rir_db = load_augmentation(opts.augmentation)
    if aug:
        logging.info("augmentation: %s (x%d)", aug.get("pipeline"), aug.get("aug_number", 1))
    ds = EgsDataset(os.path.join(opts.train_set, "wav.scp"), opts.fst_scp,
                    os.path.join(opts.train_set, "utt2len"), normalization_fst=norm_fst,
                    transform_pipeline=aug, noise_db=noise_db, rir_db=rir_db,
                    trans_mdl=opts.trans_mdl or None)
    removed = ds.filter_min_path()
    logging.info("egs: %d utts (%d removed by min-path check)", len(ds), removed)
    valid_ds = None
    if opts.valid_set and opts.valid_fst_scp:
        valid_ds = EgsDataset(os.path.join(opts.valid_set, "wav.scp"), opts.valid_fst_scp,
                              os.path.join(opts.valid_set, "utt2len"),
                              normalization_fst=norm_fst, trans_mdl=opts.trans_mdl or None)
        valid_ds.filter_min_path()

    speakers, spk_index = [], None
    if opts.model == "tdnnf_spkadv":
        speakers, spk_index = speaker_index(os.path.join(opts.train_set, "utt2spk"))
    model_id, build_params = build_params_for(opts, len(speakers))
    model = infer_helper.build_model(model_id, device=dev, seed=0, **build_params)
    if opts.init_weight_model:
        _, loaded = ckpt.load_checkpoint(opts.init_weight_model)
        merged, matched, unmatched = ckpt.match_params(model.state_dict(), loaded)
        model.load_state_dict(merged)
        logging.info("init_weight_model %s: %d tensors transferred, %d skipped%s",
                     opts.init_weight_model, len(matched), len(unmatched),
                     f" ({', '.join(unmatched[:5])}...)" if unmatched else "")
    mesh.broadcast_module(model)

    sampler = BucketBatchSampler(ds, opts.minibatch_size)
    total_steps = max(len(sampler), 1) * opts.num_epochs
    log_ratio = math.log(opts.lr_final / opts.lr_initial)

    def lr_at(step: int) -> float:
        """Exponential decay lr_initial -> lr_final over the run."""
        return opts.lr_initial * math.exp(min(step / float(total_steps), 1.0) * log_ratio)

    preprocessor_schedule = freeze_filter = None
    if opts.model.startswith("tdnnf_wav2vec2"):
        preprocessor_schedule = functools.partial(wav2vec2_update_factor,
                                                  total_steps=total_steps)
    if opts.freeze_encoder:
        def freeze_filter(name: str) -> bool:
            parts = name.split(".")
            return "acoustic" in parts and not TRAINABLE_HEADS & set(parts)

        logging.info("freeze_encoder: acoustic trunk updates zeroed "
                     "(prefinal/output heads + asi branch keep training)")
    topts = ChainTrainOpts(lr=opts.lr_initial, xent_regularize=opts.xent_regularize,
                           l2_regularize=opts.l2_regularize,
                           leaky_hmm_coefficient=opts.leaky_hmm_coefficient,
                           compute_dtype=opts.compute_dtype)
    trainer = ChainTrainer(model, den, topts, grad_acc_steps=opts.grad_acc_steps,
                           lr_schedule=lr_at, preprocessor_schedule=preprocessor_schedule,
                           freeze_filter=freeze_filter)

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
        if rank == 0:
            _save(epoch, final)
        mesh.barrier()

    def _save(epoch: int, final: bool) -> None:
        name = "final.ckpt" if final else f"{steps}.ckpt"
        infer_helper.save_model(os.path.join(opts.dirname, name), model_id,
                                build_params, model.state_dict(), extra_meta={"steps": steps})
        if not final:
            ckpt.save_trainer_checkpoint(
                os.path.join(opts.dirname, f"trainer_{steps}.ckpt"),
                {"steps": steps, "epoch": epoch}, trainer.state_dict())
        for prefix in ("", "trainer_"):
            ckpt.checkpoint_gc(opts.dirname, prefix, keep_last=10)

    def valid_objf() -> Optional[float]:
        return compute_valid_objf(model, den, valid_ds, opts.minibatch_size, topts, to_dev)

    with MetricsWriter(opts.dirname) if rank == 0 else contextlib.nullcontext() as metrics_log:
        for epoch in range(start_epoch, opts.num_epochs):
            sampler.set_epoch(epoch)
            for batch_idx in sampler:
                wavs, graphs, frames, utts = ds.load_batch(batch_idx)
                spk = (np.asarray([spk_index.get(u, 0) for u in utts])
                       if spk_index is not None else None)
                if world > 1:
                    # satpu's repeat-padding of a short batch, then this
                    # rank's contiguous block
                    rows = np.asarray(mesh.repeat_pad_rows(len(frames), world)
                                      or range(len(frames)))
                    rows = rows[mesh.local_batch_slice(len(rows), rank, world)]
                    wavs, frames = wavs[rows], frames[rows]
                    graphs = {k: np.asarray(v)[rows] for k, v in graphs.items()}
                    spk = spk[rows] if spk is not None else None
                kw = {} if spk is None else {"spk_target": torch.from_numpy(spk).to(dev)}
                metrics = trainer.step(*to_dev(wavs, graphs, frames), **kw)
                steps += 1
                if steps % opts.diagnostics_interval == 0 and rank == 0:
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
        if rank == 0:
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
