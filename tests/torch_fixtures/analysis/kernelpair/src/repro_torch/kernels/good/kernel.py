"""Fixture kernel WITH a plain version, a CUDA source and a parity test."""
def op(x):
    return x * 2
