def op(x):
    return x * 5
