"""Speaker verification (port of ``satpu.sidekit``): training, inference
and scoring.

- ``preprocessor``: mel-spectrogram and MFCC frontends (``torch.stft``) and
  the train-time time/frequency masks;
- ``nn``, ``archi``, ``pooling``, ``loss``: ECAPA-TDNN and ResNet trunks
  (batch statistics in training; satpu's bf16 policy), statistics pooling
  and the training heads, channels-first;
- ``xvector``: ``XVectorConfig``, ``EcapaXVector``, ``ResNetXVector``;
- ``dataset``: the speaker-balanced sampler and the chunk set (a numpy copy
  of satpu's);
- ``scoring``: EER, linkability, Cllr, AS-norm (a numpy copy of satpu's);
- ``trainer``: the AdamW groups, the train step, the training monitor,
  x-vector extraction and trial evaluation.
"""
from .xvector import EcapaXVector, ResNetXVector, XVectorConfig, build_xvector  # noqa: F401
