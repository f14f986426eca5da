"""The model FLOPs of every unit in the traced window (flops.call_flops)
over the window's seconds times the bf16 dense peak, in percent."""

from bounds import BF16_OPS
from flops import call_flops


def read(rec):
    t = rec["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    total = sum(call_flops(n, T, enc, rec["cfg"]) for n, T, enc in rec["units"])
    return 100.0 * total / (t["window_s"] * BF16_OPS)
