"""Data parallelism over torch.distributed (``mesh``) and process-group set-up
(``multihost``): satpu's ``parallel`` package for the port."""
from . import mesh, multihost  # noqa: F401
