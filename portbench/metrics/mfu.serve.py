"""The whole serving step's share of the card's peak: the extractor's and
the generator's operations, counted from the padded batches' shapes
(``counts.convert_flops``), over the window's wall time (no profiler),
against the peak of the precision the configuration serves in, %."""


def read(layer):
    return 100.0 * layer["mfu"] if layer.get("mfu") else None
