"""Device kernels launched per decoded image over the traced call."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.kernels or not ctx["images"]:
        return None
    return len(t.kernels) / ctx["images"]
