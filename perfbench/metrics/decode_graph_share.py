"""decode_graph_share: the window's decode steps whose forward was replayed
from CUDA graphs (an ``engine.decode.replay`` span inside the step's
``engine.decode.launch``) over the window's steps with a launch span, in %.
None where the program's span log has no replay span at all (a program
without decode graphs); 0 where it has one but replayed no step of the
window (as on the CPU, where the forward stays eager). The span log is
found as ``metrics/_spans.py`` finds it."""

from metrics import _spans


def read(out):
    try:
        from repro_torch.serving import telemetry
    except ImportError:
        return None
    log = getattr(telemetry, "SPANS", None)
    if "engine.decode.replay" not in getattr(log, "names", ()):
        return None
    spans = _spans.in_window(out, "engine.decode.launch",
                             "engine.decode.replay")
    if spans is None:
        return None
    launch = {s.arg: s for s in spans if s.name == "engine.decode.launch"}
    if not launch:
        return None
    replayed = {s.arg for s in spans if s.name == "engine.decode.replay"
                and s.arg in launch and launch[s.arg].start <= s.start
                and s.end <= launch[s.arg].end}
    return 100.0 * len(replayed) / len(launch)
