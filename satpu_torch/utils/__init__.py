"""Host-side utilities: kaldi data dirs, options, checkpoints, CUDA builds."""
