"""Fixture kernel with a plain version but NO csrc/nocsrc.cu: flagged at line 1."""
def op(x):
    return x * 5
