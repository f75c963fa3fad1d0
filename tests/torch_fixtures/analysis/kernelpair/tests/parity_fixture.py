"""Names kernels.good, kernels.nocsrc and their ref oracles (the pattern
match is textual); not a test module, so pytest never collects it."""


def parity():
    from repro_torch.kernels.good import kernel, ref
    from repro_torch.kernels.nocsrc import kernel as k2, ref as r2
    assert kernel.op(3) == ref.op(3) and k2.op(3) == r2.op(3)
