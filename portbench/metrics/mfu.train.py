"""The whole train step's share of the card's peak: the network's forward
and backward operations, counted from the batches' lengths
(``counts.train_step_flops``), over the wall time of the first half of
the window (no ranges timed, no profiler), against the peak of the precision the configuration trains in, %."""


def read(layer):
    return 100.0 * layer["mfu"] if layer.get("mfu") else None
