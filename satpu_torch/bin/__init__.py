"""CLI entry points (``python -m satpu_torch.bin.anonymize``)."""
