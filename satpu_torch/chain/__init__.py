"""LF-MMI ("chain") training of the TDNN-F extractor (port of ``satpu.chain``).

- ``fst``, ``prep``: numpy graph code (copies of satpu's), den graph and
  numerator supervisions;
- ``objf``: numerator / denominator forward and the chain objective;
- ``den_fb``: the denominator forward-backward, kernels K2f/K2b
  (``csrc/den_fb.cu``) and their plain versions;
- ``ngsgd``: natural-gradient preconditioning;
- ``dataset``, ``trainer``: egs loading and the train/valid steps.
"""
