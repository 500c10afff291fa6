"""HiFi-GAN (voice conversion) training of the anonymization generator
(port of ``satpu.bin.train_vc``).

Stages: the frozen extractor's per-utterance features (bottleneck features
of ``extract_bn`` with lengths, and YAAPT F0 through ``get_f0``, whose SHC
band is the CUDA kernel ``csrc/shc.cu`` on the card) fill the feature
caches (``fake_epoch``, or the per-speaker F0 statistics pass of
``f0_norm = speaker``); then the epoch loop of GAN steps; then, each
``checkpoint_interval`` steps and at every epoch's end, validation (the
mel error) and the checkpoints: ``g_<steps>.ckpt`` (an
``anonymizer_tdnnf_hifigan`` model that ``satpu_torch.bin.anonymize``
serves: the trained generator with the frozen extractor), ``d_<steps>.ckpt``
(the discriminators and their spectral-norm state) and
``trainer_<steps>.ckpt`` (the optimizers), a ``g_best.ckpt`` symlink, and a
sliding GC. A rerun resumes from the last triplet.

Runs on ``--device`` (CUDA unless ``--device cpu``) with TF32 off and,
unless ``--deterministic false``, cuDNN's deterministic conv algorithms
(``deterministic_convs``: two runs give the same bits); the flags are
restored on return. Under ``torchrun --nproc-per-node N`` it
trains data-parallel as satpu's multi-host step does: rank r drives
``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device cpu``), takes the
host-local batches of ``minibatch_size / N`` (``HifiGanDataset.batches``
with its process index), and the step is the global batch's
(``hifigan.trainer``). Every rank takes as many steps an epoch as the rank
with the fewest batches, so that no collective waits for a rank that has
run out; each rank caches its features in its own shard (``w<rank>``), and
rank 0 alone validates and writes the checkpoints, ``metrics.jsonl`` and
the logs.

Usage (from the repository root):
  python -m satpu_torch.bin.train_vc --config egs/vc/libritts/configs/hifigan.ini
  torchrun --nproc-per-node 2 -m satpu_torch.bin.train_vc --config ...
  python -m satpu_torch.bin.train_vc --train-set data/x --dirname exp/vc --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import logging
import os
import sys
import time

from ..utils import checkpoint as ckpt
from ..utils import config as cfg


@dataclasses.dataclass
class TrainVcOpts(cfg.Opts):
    train_set: str = ""
    dev_set: str = ""
    dirname: str = "exp/hifigan"
    asrbn_checkpoint: str = ""  # the frozen BN extractor (an asrbn_tdnnf checkpoint)
    minibatch_size: int = 8
    segment_size: int = 16640
    # "float32" | "bfloat16": compute dtype of the G / D conv stacks
    compute_dtype: str = "float32"
    lr: float = 0.0002
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    training_epochs: int = 1500
    checkpoint_interval: int = 1000
    init_weight_model: str = ""
    fake_epoch: bool = False
    num_speakers: int = 0  # 0 = the number of speakers in utt2spk
    f0_transformation: str = ""
    f0_norm: str = "utt"  # utt | speaker (per-speaker SpeakerCMVN statistics)
    # generator architecture; comma lists
    upsample_rates: str = "5,4,4,2,2"
    upsample_kernel_sizes: str = "11,8,8,4,4"
    upsample_initial_channel: int = 512
    bn_dim: int = 256
    device: str = "cuda"
    # cuDNN's deterministic conv algorithms: a run repeats bit for bit, at
    # +47.0% a B=32 f32 step and +76.5% a B=128 bf16 one (PERF.md §5)
    deterministic: bool = True


def _ints(s: str):
    return tuple(int(x) for x in s.split(","))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="")
    args, rest = parser.parse_known_args(argv)
    opts = TrainVcOpts()
    if args.config:
        ini = cfg.load_ini(args.config)
        for sec in ("exp", "hifigan", "train"):
            if sec in ini:
                opts.load_from_config(ini[sec])
    opts.load_from_args(rest)
    from .. import deterministic_convs, f32_matmuls, resolve_device
    from ..parallel import mesh, multihost

    mesh.check_batch_divisible(opts.minibatch_size, multihost.configured_world_size())
    # f32 stays f32 on the card: the f32 policy's convs, and the bf16
    # policy's f32 parts (the spectral-norm scale, the mel loss); and a run
    # repeats bit for bit
    with (multihost.distributed(resolve_device(opts.device)), f32_matmuls(),
          deterministic_convs(opts.deterministic)):
        return _train(opts)


def steps_per_epoch(n_items: int, local_bs: int, world: int) -> int:
    """The batches every rank takes an epoch: the fewest that
    ``HifiGanDataset.batches`` gives a rank (process k holds items k::P, a
    short tail wraps around, fewer items than a batch give none)."""
    counts = []
    for k in range(world):
        n = len(range(k, n_items, world))
        counts.append(0 if n < local_bs else -(-n // local_bs))
    return min(counts)


def _train(opts) -> int:
    import torch

    from .. import infer_helper, resolve_device
    from ..hifigan.dataset import HifiGanDataset
    from ..hifigan.trainer import GanHparams, GanTrainer, batch_to, split_generator_params
    from ..models.anonymizer import AnonymizationNet
    from ..parallel import mesh, multihost
    from ..utils import kaldi_data
    from ..utils.metrics import MetricsWriter

    dev = multihost.local_device(resolve_device(opts.device))
    world, rank = mesh.world(), mesh.rank()
    local_bs = multihost.host_local_batch_size(opts.minibatch_size, world)
    if rank:
        logging.getLogger().setLevel(logging.WARNING)
    os.makedirs(opts.dirname, exist_ok=True)
    utt2spk = kaldi_data.read_keyed_text(os.path.join(opts.train_set, "utt2spk"))
    speakers = sorted(set(utt2spk.values()))
    num_speakers = opts.num_speakers or len(speakers)

    if opts.asrbn_checkpoint:
        bn_model, _ = infer_helper.load_model(opts.asrbn_checkpoint, device=dev)
    else:
        logging.warning("no --asrbn-checkpoint: using a randomly initialized BN extractor "
                        "(smoke-test only)")
        bn_model = infer_helper.build_model("asrbn_tdnnf", device=dev, seed=1)
    bn_model.eval()
    asrbn_cfg = bn_model.cfg

    def bn_fn(wav, lengths):
        # the dataset pads to a bucket and crops the output to the length
        with torch.inference_mode():
            bn = bn_model.extract_bn(torch.from_numpy(wav).to(dev),
                                     torch.from_numpy(lengths).to(dev))
        return bn[0].transpose(0, 1).float().cpu().numpy()

    def f0_fn(wav, lengths):
        # YAAPT on the bucket-padded audio, as the anonymize pipeline runs it
        with torch.inference_mode():
            return AnonymizationNet.get_f0(torch.from_numpy(wav).to(dev))[0].cpu().numpy()

    build_params = {"asrbn": dataclasses.asdict(asrbn_cfg), "num_speakers": num_speakers,
                    "f0_norm": "none" if opts.f0_norm == "speaker" else opts.f0_norm,
                    "f0_transformation": opts.f0_transformation,
                    "upsample_rates": _ints(opts.upsample_rates),
                    "upsample_kernel_sizes": _ints(opts.upsample_kernel_sizes),
                    "upsample_initial_channel": opts.upsample_initial_channel,
                    "bn_dim": opts.bn_dim}
    model = infer_helper.build_model("anonymizer_tdnnf_hifigan", device=dev, seed=0,
                                     compute_dtype=opts.compute_dtype, **build_params)
    # the generator serves with the extractor it was trained on
    model.bn_extractor.load_state_dict(bn_model.state_dict())
    if opts.init_weight_model:  # a warm start of the generator alone
        generator, _ = split_generator_params(ckpt.load_checkpoint(opts.init_weight_model)[1])
        merged, matched, unmatched = ckpt.match_params(model.state_dict(), generator)
        model.load_state_dict(merged)
        logging.info("init_weight_model %s: %d generator tensors transferred, %d skipped",
                     opts.init_weight_model, len(matched), len(unmatched))

    # the cache signature ties cached BN features to the extractor
    bn_sig = f"{opts.asrbn_checkpoint}|{asrbn_cfg}"
    ds = HifiGanDataset(opts.train_set, speakers=speakers, bn_fn=bn_fn, f0_fn=f0_fn,
                        segment_size=opts.segment_size, cache_signature=bn_sig,
                        worker_name=f"w{rank}")
    f0_cmvn = None
    if opts.f0_norm == "speaker":
        from ..ops.cmvn import SpeakerCMVN

        f0_cmvn = SpeakerCMVN(keep_zeros=True)
        logging.info("f0_norm=speaker: accumulating per-speaker F0 stats")
        for i in range(len(ds)):
            _, _, f0_i, _ = ds.features(i)
            f0_cmvn.accumulate(f0_i, ds.utts[i].spk)
        ds.f0_norm_fn = lambda f0, spk: f0_cmvn(f0, spk)
    if opts.fake_epoch and f0_cmvn is None:
        logging.info("fake_epoch: warming feature caches over %d utts", len(ds))
        ds.fake_epoch(progress_cb=lambda d, t: d % 100 == 0 and logging.info("%d/%d", d, t))

    h = GanHparams(lr=opts.lr, adam_b1=opts.adam_b1, adam_b2=opts.adam_b2,
                   lr_decay=opts.lr_decay, segment_size=opts.segment_size,
                   compute_dtype=opts.compute_dtype)
    trainer = GanTrainer(model, h)
    mesh.broadcast_module(model)
    mesh.broadcast_module(trainer.mpd)
    mesh.broadcast_module(trainer.msd)

    dev_ds = None
    if opts.dev_set:
        # every rank validates: each appends to a cache shard of its own
        dev_ds = HifiGanDataset(opts.dev_set, speakers=speakers, bn_fn=bn_fn, f0_fn=f0_fn,
                                segment_size=opts.segment_size, cache_signature=bn_sig,
                                worker_name=f"w{rank}",
                                f0_norm_fn=(lambda f0, spk: f0_cmvn(f0, spk))
                                if f0_cmvn is not None else None)
        if f0_cmvn is not None:
            f0_cmvn.pass_through = True  # unseen dev speakers pass through

    last = ckpt.latest_checkpoint(opts.dirname, "trainer_")
    start_epoch, steps, best_val = 0, 0, float("inf")
    if last:
        meta, tstate = ckpt.load_trainer_checkpoint(last)
        start_epoch, steps = int(meta.get("epoch", 0)), int(meta.get("steps", 0))
        best_val = meta.get("best_val") or float("inf")
        model.load_state_dict(ckpt.load_checkpoint(
            os.path.join(opts.dirname, f"g_{steps}.ckpt"))[1])
        trainer.load_discriminator_state_dict(ckpt.load_checkpoint(
            os.path.join(opts.dirname, f"d_{steps}.ckpt"))[1])
        trainer.load_state_dict(tstate)
        trainer.epoch, trainer.step = start_epoch, steps
        logging.info("resuming from %s (epoch %d, step %d, best_val %.4f)",
                     last, start_epoch, steps, best_val)

    with MetricsWriter(opts.dirname) if rank == 0 else contextlib.nullcontext() as metrics_log:

        def validate_and_save(epoch, steps, best_val):
            # every rank validates (the generator's random stream stays alike
            # on every rank); rank 0 writes
            val_err = None
            if dev_ds is not None:
                errs = [float(trainer.eval_step(batch_to(b, dev)))
                        for b in dev_ds.batches(opts.minibatch_size, shuffle=False)]
                if errs:
                    val_err = sum(errs) / len(errs)
                    logging.info("validation mel error: %.4f (best %.4f)", val_err, best_val)
            if rank == 0:
                if val_err is not None:
                    metrics_log.write(steps, {"val_mel_error": val_err}, epoch=epoch)
                _save(opts, build_params, trainer, epoch, steps, speakers, best_val, f0_cmvn)
            if val_err is not None and val_err < best_val:
                best_val = val_err
                if rank == 0:
                    best = os.path.join(opts.dirname, "g_best.ckpt")
                    if os.path.lexists(best):
                        os.remove(best)
                    os.symlink(f"g_{steps}.ckpt", best)
            mesh.barrier()
            return best_val

        n_steps = steps_per_epoch(len(ds), local_bs, world)
        for epoch in range(start_epoch, opts.training_epochs):
            batches = ds.batches(local_bs, epoch=epoch, process_index=rank, process_count=world)
            for batch in itertools.islice(batches, n_steps):
                t0 = time.time()
                metrics = trainer.train_step(batch_to(batch, dev))
                steps += 1
                if steps % 50 == 0 and rank == 0:
                    scal = {k: float(v) for k, v in metrics.items()}
                    logging.info("Epoch %d Steps %d Gen Loss %.3f Mel err %.3f s/b %.3f",
                                 epoch + 1, steps, scal["loss_gen_all"],
                                 scal["mel_spec_error"], time.time() - t0)
                    metrics_log.write(steps, scal, epoch=epoch)
                if steps % opts.checkpoint_interval == 0:
                    best_val = validate_and_save(epoch, steps, best_val)
            trainer.epoch += 1
            best_val = validate_and_save(epoch + 1, steps, best_val)
    logging.info("training done at %d steps", steps)
    return 0


def _save(opts, build_params, trainer, epoch, steps, speakers, best_val, f0_cmvn=None):
    from .. import infer_helper

    extra = {"speakers": speakers, "epoch": epoch, "steps": steps}
    if f0_cmvn is not None:
        extra["f0_speaker_stats"] = f0_cmvn.to_meta()
    infer_helper.save_model(os.path.join(opts.dirname, f"g_{steps}.ckpt"),
                            "anonymizer_tdnnf_hifigan", build_params,
                            trainer.model.state_dict(), extra_meta=extra)
    ckpt.save_checkpoint(os.path.join(opts.dirname, f"d_{steps}.ckpt"),
                         {"epoch": epoch, "steps": steps}, trainer.discriminator_state_dict())
    ckpt.save_trainer_checkpoint(
        os.path.join(opts.dirname, f"trainer_{steps}.ckpt"),
        {"epoch": epoch, "steps": steps,
         "best_val": None if best_val == float("inf") else best_val}, trainer.state_dict())
    best = os.path.join(opts.dirname, "g_best.ckpt")
    for prefix in ("g_", "d_", "trainer_"):
        ckpt.checkpoint_gc(opts.dirname, prefix, keep_last=10,
                           keep_every=10 * opts.checkpoint_interval, protected=(best,))


if __name__ == "__main__":
    sys.exit(main())
