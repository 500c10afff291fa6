"""The benchmark's plain reference: frozen copies of the port's model, signal
and chain-training code in plain PyTorch and NumPy, with every hand-written
CUDA kernel replaced by its plain version. Nothing here imports the port,
and nothing of the port's making (weights, tables, derived graphs) is read:
the benchmark hands both sides the same inputs and weights, and the
reference works out the rest again."""
