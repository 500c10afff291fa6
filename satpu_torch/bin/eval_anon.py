"""Privacy/utility evaluation CLI (port of ``satpu.bin.eval_anon``; the
reference's egs/anon/vctk/local/eval.py loop): ASR decode -> WER (utility)
and ASV trials -> EER/linkability/Cllr (+ AS-norm) (privacy).

Inputs: an (anonymized) kaldi data dir with text, an ASR checkpoint
(loglikes -> native lattice decode over a decoding graph, optional ARPA
rescoring), an ASV checkpoint + trial lists, and optionally a cohort for
AS-norm. The networks run on ``--device`` (default ``cuda``; raises when
CUDA is absent unless ``--device cpu`` is given) in f32 with TF32 off; the
decoder and the scoring run on the host. Writes ``results.json`` (the
same keys as satpu's), and optionally ``hyp.ctm`` and a loglike ark.

Usage:
  python -m satpu_torch.bin.eval_anon --config egs/anon/vctk/configs/eval.ini
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import inspect
import json
import logging
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from .. import f32_matmuls, resolve_device
from ..parallel.mesh import serve_devices
from ..utils import config as cfg
from ..utils import kaldi_data
from ..utils.wer import corpus_wer


@dataclasses.dataclass
class EvalOpts(cfg.Opts):
    data: str = ""  # data dir (wav.scp, text, utt2spk)
    asr_checkpoint: str = ""
    decode_graph: str = ""  # HCLG-style fst
    words_txt: str = ""
    acoustic_scale: float = 1.0
    batch_size: int = 32
    beam: float = 16.0
    lattice_beam: float = 8.0
    max_active: int = 7000
    rescore_lm: str = ""  # big ARPA (.arpa/.arpa.gz) for LM rescoring
    decode_lm: str = ""  # the decode graph's ARPA, subtracted when rescoring
    lm_scale: float = 1.0
    nbest: int = 100
    # "exact" = full lattice x ARPA composition (kaldi ConstArpa semantics);
    # "nbest" = unique-word-sequence N-best approximation (faster)
    rescore_mode: str = "exact"
    write_ctm: bool = False
    dump_loglikes: str = ""  # optional ark path: per-utt loglike matrices
    asv_checkpoint: str = ""
    enroll_dir: str = ""  # data dir of enrollment utterances
    trials: str = ""  # "spk utt target|nontarget" lines
    cohort_dir: str = ""
    cohort_size: int = 400  # top-N cohort utterances (reference asnorm top-400)
    # split loglike batches over every local card (the serving mesh)
    serve_mesh: bool = False
    xvector_mode: str = "chunked"  # "full" = reference batch=1 full-utterance
                                   # extraction protocol (objf.py:228-258)
    ece_plot: bool = False  # write results/ece.png (needs matplotlib)
    results: str = "exp/eval"
    device: str = "cuda"


def evaluate_asr(opts, devices: Optional[Sequence] = None) -> dict:
    """WER over the data dir: bucketed batched loglikes on the device, native
    lattice decode + optional big-LM rescoring on the host (the reference's
    decode | latgen-faster-mapped | rescore | score flow,
    egs/anon/vctk/local/eval.py:124-194). With several ``devices`` (the
    serving mesh) the model is replicated on each and every batch is split
    into contiguous blocks, one a device, gathered in order."""
    from .. import infer_helper, native
    from ..chain.decoder import best_path_decode, read_words_txt
    from ..chain.fst import Fst
    from ..chain.lattice import ArpaLM, best_path, nbest, rescore_lattice, rescore_nbest, to_ctm
    from ..models.asrbn import output_num_frames
    from ..parallel import mesh
    from .pipeline import DEFAULT_BUCKETS, _start_host_copy, bucket_for

    model, _ = infer_helper.load_model(opts.asr_checkpoint, device=opts.device)
    # the fbank nets mask a padded batch by its lengths; the wav2vec2 net
    # takes none (as in satpu)
    takes_len = "lengths" in inspect.signature(model.forward).parameters
    device = next(model.parameters()).device
    devices = [torch.device(d) for d in devices] if devices else [device]
    replicas = [model if d == device else copy.deepcopy(model).to(d) for d in devices]
    graph = Fst.read(opts.decode_graph)
    words = read_words_txt(opts.words_txt) if opts.words_txt else None
    word_table = words or {}
    utt2wav = kaldi_data.read_wav_scp(os.path.join(opts.data, "wav.scp"))
    refs = kaldi_data.read_keyed_text(os.path.join(opts.data, "text"))

    new_lm = ArpaLM(opts.rescore_lm) if opts.rescore_lm else None
    old_lm = ArpaLM(opts.decode_lm) if opts.decode_lm else None
    use_native = native.available()
    ng = native.NativeGraph(graph) if use_native else None
    if not use_native:
        logging.warning("native decoder unavailable; falling back to the "
                        "python best-path decoder (no lattices/rescoring)")

    # bucketed batches: load lengths, sort, pad (B, bucket)
    entries = []
    for utt, spec in utt2wav.items():
        wav, _ = kaldi_data.load_wav_from_scp(spec)
        entries.append((utt, wav[0].astype(np.float32)))
    entries.sort(key=lambda e: len(e[1]))

    hyps = {}
    ctm = {}
    ll_writer = None
    if opts.dump_loglikes:
        from ..utils.scp_io import FileWriter

        ll_writer = FileWriter(opts.dump_loglikes,
                               os.path.splitext(opts.dump_loglikes)[0] + ".scp")

    def decode_one(utt, ll):
        """Host-side lattice decode + rescore for one utterance; runs in a
        thread pool overlapped with the next batch's device compute (the
        native decoder releases the GIL)."""
        if use_native:
            lat = native.decode_lattice(
                ng, ll, acoustic_scale=opts.acoustic_scale, beam=opts.beam,
                lattice_beam=opts.lattice_beam, max_active=opts.max_active)
            if new_lm is not None:
                if opts.rescore_mode == "exact":
                    # kaldi LatticeLmrescoreConstArpa semantics (composition)
                    hyp = rescore_lattice(lat, word_table, new_lm,
                                          old_lm=old_lm, lm_scale=opts.lm_scale)
                else:
                    hs = rescore_nbest(nbest(lat, opts.nbest), word_table,
                                       new_lm, old_lm=old_lm,
                                       lm_scale=opts.lm_scale)
                    hyp = hs[0] if hs else None
            else:
                hyp = best_path(lat)
                if hyp is not None:
                    hyp["text"] = " ".join(
                        word_table.get(w_, str(w_)) for w_ in hyp["words"])
            hyps[utt] = hyp["text"] if hyp else ""
            if opts.write_ctm and hyp:
                ctm[utt] = to_ctm(hyp, word_table, utt=utt)
        else:
            res = best_path_decode(ll, graph,
                                   acoustic_scale=opts.acoustic_scale,
                                   word_table=words)
            hyps[utt] = res.text

    def submit(batch, host, done):
        """Wait for a batch's loglikes on the host; queue its decodes."""
        if done is not None:
            done.synchronize()
        ll_b = host.numpy()
        for j, (utt, w) in enumerate(batch):
            ll = ll_b[j, : output_num_frames(len(w))].copy()
            if ll_writer is not None:
                ll_writer.write(utt, ll)
            futures.append(pool.submit(decode_one, utt, ll))

    B = opts.batch_size
    futures = []
    in_flight = None
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool, torch.inference_mode():
        for i in range(0, len(entries), B):
            batch = entries[i : i + B]
            # lengths pad to the bucket ladder; the batch dim is not padded
            # (rows are independent at inference)
            bucket = bucket_for(max(len(w) for _, w in batch), DEFAULT_BUCKETS)
            wav_b = np.zeros((len(batch), bucket), np.float32)
            lens = np.zeros((len(batch),), np.int64)
            for j, (_, w) in enumerate(batch):
                wav_b[j, : len(w)] = w
                lens[j] = len(w)
            wavs, lens_b = (mesh.split_rows(torch.from_numpy(a), devices) for a in (wav_b, lens))
            chain_out = mesh.gather_rows([(m(w, n) if takes_len else m(w))[0].float()
                                          for m, w, n in zip(replicas, wavs, lens_b)])
            # decode the PREVIOUS batch while the device computes this one
            if in_flight is not None:
                submit(*in_flight)
            in_flight = (batch, *_start_host_copy(chain_out))
        if in_flight is not None:
            submit(*in_flight)
        for f in futures:
            f.result()
    if ll_writer is not None:
        ll_writer.close()
    if ctm:
        with open(os.path.join(opts.results, "hyp.ctm"), "w") as f:
            for utt in sorted(ctm):
                f.write("\n".join(ctm[utt]) + "\n")
    wer = corpus_wer(refs, hyps)
    logging.info("ASR %s", wer)
    return {"wer": wer.wer * 100, "errors": wer.errors, "words": wer.words}


def evaluate_asv(opts) -> dict:
    from .. import infer_helper
    from ..sidekit.trainer import asv_test, extract_xvectors

    model, _ = infer_helper.load_model(opts.asv_checkpoint, device=opts.device)
    enroll_wav = kaldi_data.read_wav_scp(os.path.join(opts.enroll_dir, "wav.scp"))
    enroll_spk = kaldi_data.read_keyed_text(os.path.join(opts.enroll_dir, "utt2spk"))
    enroll = {}
    for utt, spec in enroll_wav.items():
        wav, _ = kaldi_data.load_wav_from_scp(spec)
        enroll.setdefault(enroll_spk[utt], []).append(wav[0])
    trial_wav = kaldi_data.read_wav_scp(os.path.join(opts.data, "wav.scp"))
    trial_wavs = {}
    trials = []
    with open(opts.trials) as f:
        for line in f:
            spk, utt, label = line.split()
            trials.append((spk, utt, label in ("target", "tgt", "1")))
            if utt not in trial_wavs:
                wav, _ = kaldi_data.load_wav_from_scp(trial_wav[utt])
                trial_wavs[utt] = wav[0]
    cohort_xv = None
    if opts.cohort_dir:
        cw = kaldi_data.read_wav_scp(os.path.join(opts.cohort_dir, "wav.scp"))
        if len(cw) > opts.cohort_size:
            logging.info("AS-norm cohort capped at %d of %d utterances "
                         "(--cohort-size)", opts.cohort_size, len(cw))
        wavs = []
        for utt, spec in list(cw.items())[: opts.cohort_size]:
            wav, _ = kaldi_data.load_wav_from_scp(spec)
            wavs.append(wav[0])
        cohort_xv = extract_xvectors(model, wavs, mode=opts.xvector_mode)
    else:
        # reference default: the ArcMargin class-center weights serve as the
        # AS-norm cohort (objf.py:260-266: after_speaker_embedding.weight,
        # L2-normalized)
        w = model.after_speaker_embedding.weight.detach().cpu().numpy()
        cohort_xv = w / np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-12)
        logging.info("AS-norm cohort: %d ArcMargin class centers "
                     "(no --cohort-dir given)", len(cohort_xv))
    metrics = asv_test(model, enroll, trials, trial_wavs,
                       cohort_xv=cohort_xv,
                       metric_path=os.path.join(opts.results, "metric.json"),
                       xvector_mode=opts.xvector_mode,
                       ece_plot_path=(os.path.join(opts.results, "ece")
                                      if opts.ece_plot else None))
    logging.info("ASV %s", metrics)
    return metrics


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="", help="INI config path")
    args, rest = parser.parse_known_args(argv)
    opts = EvalOpts()
    if args.config:
        ini = cfg.load_ini(args.config)
        for sec, kv in ini.items():
            if sec != "var":
                opts.load_from_config(kv)
    opts.load_from_args(rest)
    dev = resolve_device(opts.device)
    devices = serve_devices(dev) if opts.serve_mesh else [dev]
    if len(devices) > 1:
        if opts.batch_size % len(devices):
            raise ValueError(f"serve_mesh needs batch_size ({opts.batch_size}) divisible by "
                             f"the device count ({len(devices)})")
        logging.info("serve_mesh: loglike batches split over %d devices", len(devices))
    elif opts.serve_mesh:
        logging.info("serve_mesh: one device, batches run unsharded")
    os.makedirs(opts.results, exist_ok=True)
    out = {}
    # the cosine scores are thresholded: TF32's 10-bit inputs would move EER ties
    with f32_matmuls():
        if opts.asr_checkpoint:
            out["asr"] = evaluate_asr(opts, devices)
        if opts.asv_checkpoint:
            out["asv"] = evaluate_asv(opts)
    with open(os.path.join(opts.results, "results.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
