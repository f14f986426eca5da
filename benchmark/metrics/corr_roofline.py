"""The correlation layer's least time (bounds.corr_call_s, from the cell's
shapes) over its device time in the `corr` span, in percent."""

from bounds import corr_call_s


def read(rec):
    t = rec["trace"]
    if t is None or not t["spans"].get("corr", {}).get("device_s"):
        return None
    least = sum(corr_call_s(n, T, rec["cfg"]) for n, T, _ in rec["units"])
    return 100.0 * least / t["spans"]["corr"]["device_s"]
