"""engine_step_ms: the window's seconds over the decode steps that ended in
it (``decode_step`` events): sweep, admission, decode and retirement."""


def read(out):
    n = len(out.window.decodes_in())
    return out.window.seconds / n * 1e3 if n else None
