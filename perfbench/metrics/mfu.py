"""mfu: useful model FLOPs of the window (``_work``: every real prompt and
generated token, top-k experts, LoRA, attention over its positions; no
pad, inactive row or capacity slot) over the window's seconds times the
card's bf16 dense peak, in %."""

from metrics import _work


def read(out):
    cfg, win = out.cfg, out.window
    flops = 0.0
    for e, _ in win.prefills_in():
        flops += sum(_work.prompt_flops(cfg, out.prompt_len[r])
                     for r in e["request_ids"])
    per = _work.per_token(cfg)
    for _, f in win.decodes_in():
        flops += sum(per + _work.attention(cfg, idx + 1)
                     for _, _, idx in f.rows)
    if flops <= 0:
        return None
    return 100.0 * flops / (win.seconds * _work.PEAK_FLOPS)
