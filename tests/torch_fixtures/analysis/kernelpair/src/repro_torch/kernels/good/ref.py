def op(x):
    return x * 2
