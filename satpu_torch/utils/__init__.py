"""Host-side utilities: kaldi data dirs, options, checkpoints, CUDA builds."""
from . import checkpoint, config, kaldi_data, scp_io  # noqa: F401
from .config import Opts, load_ini, split_dict, str2bool  # noqa: F401
from .kaldi_data import (  # noqa: F401
    WavInfo,
    WavScpDataset,
    load_wav_from_scp,
    parse_wavinfo_wav,
    read_keyed_text,
    read_wav_scp,
    write_wav,
)
