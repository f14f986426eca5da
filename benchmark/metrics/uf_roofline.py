"""The update transformer's W8A8 blocks' least time (bounds.uf_call_s, from
the cell's shapes) over the device time in the `uf` span, in percent."""

from bounds import uf_call_s


def read(rec):
    t = rec["trace"]
    if t is None or not t["spans"].get("uf", {}).get("device_s"):
        return None
    least = sum(uf_call_s(n, T, rec["cfg"]) for n, T, _ in rec["units"])
    return 100.0 * least / t["spans"]["uf"]["device_s"]
