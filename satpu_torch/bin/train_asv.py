"""ASV (x-vector) training of the privacy judge (port of
``satpu.bin.train_asv``; the reference's egs/asv/voxceleb/local/train.py and
SidekitModel loop, sidekit/model.py:325-493).

An epoch loop of train steps over ``SideSampler``-balanced batches of
``SideSet`` chunks (random shift and waveform augmentation on the host,
SpecAugment masks on the device), then a validation EER on up to 64 chunks,
``TrainingMonitor`` early stopping, and the checkpoints: ``<epoch>.ckpt``
(an ``asv_xvector`` model with ``speakers`` and ``epoch`` in its meta, which
``satpu_torch.bin.eval_anon --asv-checkpoint`` loads), ``trainer_<epoch>.ckpt``
(the optimizer, the step and the monitor), a ``best.ckpt`` symlink, and a GC
that keeps 10 model and 2 trainer checkpoints. A rerun resumes from the last
trainer checkpoint.

The learning-rate schedule's epoch length is satpu's: speakers x
``samples_per_speaker`` / ``minibatch_size`` steps, though the sampler
yields ``examples_per_speaker`` times more (ROADMAP, "satpu-side gaps").

Runs on ``--device`` (CUDA unless ``--device cpu``) with TF32 off (the
flags are restored on return). Under ``torchrun --nproc-per-node N`` it
trains data-parallel as satpu's ``data`` mesh does: rank r drives
``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device cpu``), every rank draws
the same global batch and trains on its contiguous block
(``sidekit.trainer``: the batch norms and SpecAugment draws are the global
batch's); ``minibatch_size`` must be a multiple of N; rank 0 alone writes
the checkpoints, ``metrics.jsonl`` and the logs.

Usage (from the repository root):
  python -m satpu_torch.bin.train_asv --config egs/asv/voxceleb/configs/ecapa.ini
  torchrun --nproc-per-node 2 -m satpu_torch.bin.train_asv --config ...
  python -m satpu_torch.bin.train_asv --train-set data/x --dirname exp/asv --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import sys

from ..utils import checkpoint as ckpt
from ..utils import config as cfg


@dataclasses.dataclass
class TrainAsvOpts(cfg.Opts):
    train_set: str = ""
    dirname: str = "exp/asv"
    arch: str = "ecapa"  # ecapa | resnet
    channels: int = 512
    embedding_size: int = 192
    duration: float = 3.0
    examples_per_speaker: int = 2
    samples_per_speaker: int = 100
    minibatch_size: int = 128
    lr: float = 1e-3
    weight_decay: float = 2e-5
    # the ArcMargin head decays 10x harder (tuning/ecapa_tdnn.py:59)
    head_weight_decay: float = 2e-4
    # one_cycle (OneCycleLR, configs/ecapa_tdnn:35) | exponential (per-epoch
    # gamma, configs/ecapa_tdnn_fine_tune:35) | constant
    lr_schedule: str = "one_cycle"
    lr_gamma: float = 0.2  # the exponential schedule's per-epoch factor
    # inline lenient JSON or a .json path (ops.augment.load_augmentation)
    augmentation: str = ""
    epochs: int = 100
    patience: int = 10
    fine_tune: bool = False  # ArcMargin m 0.4, no SpecAugment, no random shift
    compute_dtype: str = "float32"  # | bfloat16 (satpu's autocast policy)
    # warm start: the shape-matching tensors of this checkpoint
    init_weight_model: str = ""
    seed: int = 1234
    device: str = "cuda"


def steps_per_epoch(num_speakers: int, opts: TrainAsvOpts) -> int:
    """The schedule's epoch length, satpu's formula (train_asv.py:109-110):
    it leaves out ``examples_per_speaker``."""
    return max((num_speakers * opts.samples_per_speaker) // opts.minibatch_size, 1)


def lr_schedule(opts: TrainAsvOpts, spe: int):
    """step -> learning rate for ``opts.lr_schedule`` (None: constant)."""
    if opts.lr_schedule == "one_cycle":
        from ..utils.schedules import one_cycle

        return one_cycle(opts.lr, spe * opts.epochs, div_factor=4.0)
    if opts.lr_schedule == "exponential":
        return lambda step: opts.lr * opts.lr_gamma ** (step // spe)
    if opts.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {opts.lr_schedule!r}")
    return None


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="")
    args, rest = parser.parse_known_args(argv)
    opts = TrainAsvOpts()
    if args.config:
        for sec, kv in cfg.load_ini(args.config).items():
            if sec != "var":
                opts.load_from_config(kv)
    opts.load_from_args(rest)
    from .. import f32_matmuls, resolve_device
    from ..parallel import mesh, multihost

    mesh.check_batch_divisible(opts.minibatch_size, multihost.configured_world_size())
    with multihost.distributed(resolve_device(opts.device)), f32_matmuls():
        return _train(opts)


def _train(opts: TrainAsvOpts) -> int:
    import numpy as np
    import torch

    from .. import infer_helper, resolve_device
    from ..ops.augment import load_augmentation
    from ..sidekit.dataset import SideSampler, SideSet
    from ..sidekit.trainer import (AsvTrainer, TrainingMonitor, extract_xvectors,
                                   make_asv_optimizer, validation_eer)
    from ..parallel import mesh, multihost
    from ..sidekit.xvector import XVectorConfig
    from ..utils.metrics import MetricsWriter

    dev = multihost.local_device(resolve_device(opts.device))
    world, rank = mesh.world(), mesh.rank()
    if rank:
        logging.getLogger().setLevel(logging.WARNING)
    os.makedirs(opts.dirname, exist_ok=True)
    aug, noise_db, rir_db = load_augmentation(opts.augmentation)
    if aug:
        logging.info("augmentation: %s (x%d)", aug.get("pipeline"), aug.get("aug_number", 1))
    side = SideSet.from_data_dir(opts.train_set, duration=opts.duration,
                                 random_shift=not opts.fine_tune, transform_pipeline=aug,
                                 noise_db=noise_db, rir_db=rir_db)
    speakers = side.speakers
    logging.info("%d chunks over %d speakers", len(side), len(speakers))

    xcfg = XVectorConfig(num_speakers=len(speakers), arch=opts.arch, channels=opts.channels,
                         embedding_size=opts.embedding_size, spec_augment=not opts.fine_tune)
    build_params = dataclasses.asdict(xcfg)
    model = infer_helper.build_model("asv_xvector", device=dev, seed=opts.seed, **build_params)
    if opts.init_weight_model:
        loaded = ckpt.load_checkpoint(opts.init_weight_model)[1]
        merged, matched, unmatched = ckpt.match_params(model.state_dict(), loaded)
        model.load_state_dict(merged)
        logging.info("init_weight_model %s: %d tensors transferred, %d skipped",
                     opts.init_weight_model, len(matched), len(unmatched))
    mesh.broadcast_module(model)
    optimizer = make_asv_optimizer(model, lr=opts.lr, weight_decay=opts.weight_decay,
                                   head_weight_decay=opts.head_weight_decay)
    spe = steps_per_epoch(len(speakers), opts)
    trainer = AsvTrainer(model, optimizer, lr_schedule=lr_schedule(opts, spe),
                         arc_m=0.4 if opts.fine_tune else None,
                         compute_dtype=opts.compute_dtype)
    monitor = TrainingMonitor(patience=opts.patience)

    start_epoch = 0
    last = ckpt.latest_checkpoint(opts.dirname, "trainer_")
    if last:
        meta, tstate = ckpt.load_trainer_checkpoint(last)
        start_epoch = meta["epoch"] + 1
        monitor.load_state_dict(meta["monitor"])
        model.load_state_dict(ckpt.load_checkpoint(
            os.path.join(opts.dirname, f"{meta['epoch']}.ckpt"))[1])
        trainer.load_state_dict(tstate)
        logging.info("resuming from %s (epoch %d, best EER %.2f%% @ %d)", last, start_epoch,
                     monitor.best_eer * 100, monitor.best_epoch)

    sampler = SideSampler(side.chunk_speakers, len(speakers), opts.examples_per_speaker,
                          opts.samples_per_speaker, opts.minibatch_size, seed=opts.seed)
    with MetricsWriter(opts.dirname) if rank == 0 else contextlib.nullcontext() as metrics_log:
        for epoch in range(start_epoch, opts.epochs):
            sampler.set_epoch(epoch)
            # the SpecAugment masks' stream, one an epoch (a resumed run draws
            # the same masks)
            gen = torch.Generator(device=dev).manual_seed(opts.seed + 1 + epoch)
            losses = []
            for wav, spk in side.batches(sampler, opts.minibatch_size):
                if world > 1:  # this rank's contiguous block of the global batch
                    rows = mesh.local_batch_slice(len(wav), rank, world)
                    wav, spk = wav[rows], spk[rows]
                metrics = trainer.train_step(torch.from_numpy(wav).to(dev),
                                             torch.from_numpy(spk).long().to(dev), gen)
                losses.append(metrics["loss"])
            loss = (float(np.mean(torch.stack(losses).double().cpu().numpy())) if losses
                    else float("nan"))
            # a quick validation on up to 64 chunks of the training set, each
            # read twice as satpu reads it (for the audio, then the label): the
            # reads move the set's random streams, and the next epoch's crops
            # depend on them (every rank validates: the streams and the early
            # stop stay alike)
            val_idx = list(range(0, len(side), max(len(side) // 64, 1)))[:64]
            wavs = [side[i][0] for i in val_idx]
            labels = np.asarray([side[i][1] for i in val_idx])
            model.eval()
            eer = validation_eer(extract_xvectors(model, wavs), labels)
            is_best = monitor.update(epoch, eer)
            logging.info("epoch %d loss %.3f val-EER %.2f%%%s", epoch, loss, eer * 100,
                         " (best)" if is_best else "")
            if rank == 0:
                metrics_log.write(trainer.step, {"loss": loss, "val_eer": eer}, epoch=epoch)
                _save(opts, build_params, trainer, monitor, epoch, speakers, is_best)
            mesh.barrier()
            if monitor.should_stop:
                logging.info("early stop at epoch %d (best %.2f%% @ %d)", epoch,
                             monitor.best_eer * 100, monitor.best_epoch)
                break
    return 0


def _save(opts, build_params, trainer, monitor, epoch, speakers, is_best) -> None:
    from .. import infer_helper

    path = os.path.join(opts.dirname, f"{epoch}.ckpt")
    infer_helper.save_model(path, "asv_xvector", build_params, trainer.model.state_dict(),
                            extra_meta={"speakers": speakers, "epoch": epoch})
    ckpt.save_trainer_checkpoint(
        os.path.join(opts.dirname, f"trainer_{epoch}.ckpt"),
        {"epoch": epoch, "step": trainer.step, "monitor": monitor.state_dict()},
        trainer.state_dict())
    best = os.path.join(opts.dirname, "best.ckpt")
    if is_best:
        if os.path.lexists(best):
            os.remove(best)
        os.symlink(os.path.basename(path), best)
    ckpt.checkpoint_gc(opts.dirname, "", keep_last=10, protected=(best,))
    ckpt.checkpoint_gc(opts.dirname, "trainer_", keep_last=2)


if __name__ == "__main__":
    sys.exit(main())
