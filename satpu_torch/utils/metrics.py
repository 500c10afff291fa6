"""Training metrics and observability shared by the port's trainers (port of
``satpu.utils.metrics``).

An append-only ``metrics.jsonl`` per experiment dir, one JSON object per
event with a wall-clock timestamp, a step counter and scalar fields; when
the ``tensorboard`` package imports, the scalars (and audio / image / text
samples, and with ``attach_log_handler`` the log records) are mirrored into
tensorboard event files under ``<exp_dir>/tb`` (``TensorBoardMirror``: raw
Summary protos, no torch dependency). ``SATPU_TENSORBOARD=0`` switches the
mirror off. The trainers' spans and the kernels' launch counters are
``utils.trace``'s.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np


class TensorBoardMirror:
    """Minimal tensorboard event writer (scalars / audio / image / text) with
    no torch dependency — raw Summary protos through EventFileWriter."""

    def __init__(self, logdir: str):
        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.event_file_writer import EventFileWriter

        self._event_pb2 = event_pb2
        self._summary_pb2 = summary_pb2
        self._writer = EventFileWriter(logdir)

    def _emit(self, step: int, values) -> None:
        ev = self._event_pb2.Event(
            wall_time=time.time(), step=int(step),
            summary=self._summary_pb2.Summary(value=values))
        self._writer.add_event(ev)

    def scalars(self, step: int, scalars: Dict[str, float]) -> None:
        S = self._summary_pb2.Summary
        vals = []
        for k, v in scalars.items():
            try:
                vals.append(S.Value(tag=k, simple_value=float(v)))
            except (TypeError, ValueError):
                continue
        if vals:
            self._emit(step, vals)

    def audio(self, step: int, tag: str, wav: np.ndarray, sample_rate: int) -> None:
        """Mono float32 [-1,1] waveform sample (hifigan/model.py:481-489)."""
        from .kaldi_data import wav_bytes

        wav = np.asarray(wav, np.float32).reshape(-1)
        S = self._summary_pb2.Summary
        self._emit(step, [S.Value(tag=tag, audio=S.Audio(
            sample_rate=float(sample_rate), num_channels=1,
            length_frames=len(wav), content_type="audio/wav",
            encoded_audio_string=wav_bytes(wav, sample_rate)))])

    def image(self, step: int, tag: str, array: np.ndarray) -> None:
        """2-D array (e.g. a mel spectrogram) as a viridis-colored PNG
        (the reference's plot_spectrogram figures, hifigan/model.py:490-502)."""
        import io

        from PIL import Image

        a = np.asarray(array, np.float32)
        lo, hi = float(a.min()), float(a.max())
        norm = (a - lo) / (hi - lo + 1e-9)
        # tiny built-in colormap: dark blue -> green -> yellow
        anchors = np.array([[68, 1, 84], [33, 145, 140], [253, 231, 37]], np.float32)
        idx = norm * (len(anchors) - 1)
        i0 = np.clip(idx.astype(np.int32), 0, len(anchors) - 2)
        frac = (idx - i0)[..., None]
        rgb = (anchors[i0] * (1 - frac) + anchors[i0 + 1] * frac).astype(np.uint8)
        rgb = rgb[::-1]  # low freq at the bottom, like matplotlib origin="lower"
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="png")
        S = self._summary_pb2.Summary
        self._emit(step, [S.Value(tag=tag, image=S.Image(
            height=rgb.shape[0], width=rgb.shape[1], colorspace=3,
            encoded_image_string=buf.getvalue()))])

    def text(self, step: int, tag: str, text: str) -> None:
        """Text summary (the reference mirrors log lines into TB text via
        LogHandlerSummaryWriter, utils/tensorboard_log.py:6-42)."""
        from tensorboard.compat.proto.tensor_pb2 import TensorProto
        from tensorboard.compat.proto.tensor_shape_pb2 import TensorShapeProto

        S = self._summary_pb2
        meta = S.SummaryMetadata(
            plugin_data=S.SummaryMetadata.PluginData(plugin_name="text"))
        tensor = TensorProto(
            dtype=7,  # DT_STRING
            string_val=[text.encode("utf-8")],
            tensor_shape=TensorShapeProto(dim=[TensorShapeProto.Dim(size=1)]))
        self._emit(step, [S.Summary.Value(tag=tag, metadata=meta, tensor=tensor)])

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


class TensorBoardLogHandler(logging.Handler):
    """Mirror python logging records into tensorboard text, like the
    reference's LogHandlerSummaryWriter (utils/tensorboard_log.py:6-42)."""

    def __init__(self, mirror: TensorBoardMirror, tag: str = "log"):
        super().__init__()
        self.mirror = mirror
        self.tag = tag
        self._n = 0

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.mirror.text(self._n, self.tag, self.format(record))
            self._n += 1
        except Exception:  # noqa: BLE001 - logging reports its own failures
            self.handleError(record)


class MetricsWriter:
    """Append-only JSONL scalar logger, one file per experiment dir, with a
    tensorboard mirror under ``<exp_dir>/tb`` when tensorboard is available.

    Mirrors the role of the reference's SummaryWriter wiring; ``global_step``
    persists across resumes like chain/tensorboard.py:20-31. Disable the TB
    mirror with tensorboard=False or SATPU_TENSORBOARD=0.
    """

    def __init__(self, exp_dir: str, name: str = "metrics.jsonl",
                 tensorboard: Optional[bool] = None):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, name)
        self._fh = open(self.path, "a", buffering=1)
        self.tb: Optional[TensorBoardMirror] = None
        if tensorboard is None:
            tensorboard = os.environ.get("SATPU_TENSORBOARD", "1") != "0"
        if tensorboard:
            try:
                self.tb = TensorBoardMirror(os.path.join(exp_dir, "tb"))
            except ImportError:
                pass

    def write(self, step: int, tag_or_scalars, value: Optional[float] = None,
              **extra: Any) -> None:
        """write(step, "loss", 1.3) or write(step, {"loss": 1.3, "lr": 2e-4})."""
        if isinstance(tag_or_scalars, str):
            scalars: Dict[str, Any] = {tag_or_scalars: value}
        else:
            scalars = dict(tag_or_scalars)
        rec = {"t": round(time.time(), 3), "step": int(step)}
        for k, v in {**scalars, **extra}.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            self.tb.scalars(step, {k: v for k, v in rec.items()
                                   if k not in ("t", "step")})

    def audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        if self.tb is not None:
            self.tb.audio(step, tag, np.asarray(wav), sample_rate)

    def image(self, step: int, tag: str, array) -> None:
        if self.tb is not None:
            self.tb.image(step, tag, np.asarray(array))

    def attach_log_handler(self) -> None:
        """Mirror root-logger records into this writer's TB dir. Detaches any
        TensorBoardLogHandler left behind by a previous in-process driver
        invocation (repeated main() calls must not accumulate handlers that
        write into stale experiments' event files)."""
        root = logging.getLogger()
        for h in [h for h in root.handlers
                  if isinstance(h, TensorBoardLogHandler)]:
            root.removeHandler(h)
        self._log_handler: Optional[TensorBoardLogHandler] = None
        if self.tb is not None:
            self._log_handler = TensorBoardLogHandler(self.tb)
            root.addHandler(self._log_handler)

    def close(self) -> None:
        handler = getattr(self, "_log_handler", None)
        if handler is not None:
            logging.getLogger().removeHandler(handler)
            self._log_handler = None
        self._fh.close()
        if self.tb is not None:
            self.tb.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
