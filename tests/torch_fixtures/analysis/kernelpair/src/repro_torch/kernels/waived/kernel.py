# analysis: allow(kernel-ref-pair): fixture, a waived kernel without its plain version
def op(x):
    return x * 4
