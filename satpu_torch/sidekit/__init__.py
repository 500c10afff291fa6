"""Speaker verification (port of ``satpu.sidekit``), inference and scoring.

- ``preprocessor``: mel-spectrogram and MFCC frontends (``torch.stft``);
- ``nn``, ``archi``, ``pooling``, ``loss``: ECAPA-TDNN and ResNet trunks,
  statistics pooling and the ArcMargin head, channels-first;
- ``xvector``: ``XVectorConfig``, ``EcapaXVector``, ``ResNetXVector``;
- ``scoring``: EER, linkability, Cllr, AS-norm (a numpy copy of satpu's);
- ``trainer``: x-vector extraction and trial evaluation.
"""
from .xvector import EcapaXVector, ResNetXVector, XVectorConfig, build_xvector  # noqa: F401
