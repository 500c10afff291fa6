"""The port's metrics log (``satpu_torch.utils.metrics``, a port of
``satpu.utils.metrics``): the JSONL lines are satpu's, the tensorboard mirror
writes scalar, audio, image and text events that tensorboard reads back
(tensorboard is installed here; the card's machine has none, and then the
mirror is off), and the log handler mirrors records and detaches."""
import json
import logging
import os

import numpy as np
import torch


def _jsonl(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(x).items() if k != "t"} for x in f]


def test_jsonl_and_tensorboard_mirror(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from satpu.utils.metrics import MetricsWriter as JWriter
    from satpu_torch.utils.metrics import MetricsWriter

    for name, cls in (("port", MetricsWriter), ("satpu", JWriter)):
        w = cls(str(tmp_path / name))
        w.write(3, {"loss": 1.25, "lr": torch.tensor(2e-4), "tag": "x"}, epoch=1)
        w.write(4, "val_eer", 0.5)
        if name == "port":
            w.audio(4, "sample", np.sin(np.arange(1600) / 10.0).astype(np.float32), 16000)
            w.image(4, "mel", np.random.default_rng(0).random((8, 12)))
            w.attach_log_handler()
            logging.getLogger().warning("mirrored line")
        w.close()
    assert _jsonl(tmp_path / "port" / "metrics.jsonl") == _jsonl(
        tmp_path / "satpu" / "metrics.jsonl")
    assert not any(isinstance(h, logging.Handler) and type(h).__name__ ==
                   "TensorBoardLogHandler" for h in logging.getLogger().handlers)
    ea = EventAccumulator(str(tmp_path / "port" / "tb"), size_guidance={"scalars": 0})
    ea.Reload()
    tags = ea.Tags()
    assert {"loss", "lr", "epoch", "val_eer"} <= set(tags["scalars"])
    assert [(e.step, e.value) for e in ea.Scalars("loss")] == [(3, 1.25)]
    assert abs(ea.Scalars("lr")[0].value - 2e-4) < 1e-9
    assert "sample" in tags["audio"] and "mel" in tags["images"]
    assert "log" in tags["tensors"]


def test_mirror_off(tmp_path, monkeypatch):
    from satpu_torch.utils.metrics import MetricsWriter

    monkeypatch.setenv("SATPU_TENSORBOARD", "0")
    with MetricsWriter(str(tmp_path)) as w:
        w.write(1, {"loss": 1.0})
        assert w.tb is None
    assert os.listdir(tmp_path) == ["metrics.jsonl"]

