"""Device ms a predictor call inside the `uf` span (benchmark/spans.py):
the device time of the operations the span launched, over the traced
window's calls. A span that lost its calls or its time reads nothing,
never 0."""


def read(rec):
    t = rec["trace"]
    if t is None or not t["spans"].get("uf", {}).get("device_s") or not rec["units"]:
        return None  # no call, or no device time, inside the span: nothing to read
    return 1e3 * t["spans"]["uf"]["device_s"] / len(rec["units"])
