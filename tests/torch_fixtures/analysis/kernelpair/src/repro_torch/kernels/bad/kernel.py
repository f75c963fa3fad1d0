"""Fixture kernel with NO sibling ref.py: flagged at line 1."""
def op(x):
    return x * 3
