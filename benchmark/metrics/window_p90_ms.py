"""The 90th percentile of every window's time in the run, first windows of
each stream included: from handing the chunk to the online predictor to
that window's tracks and visibility being on the host."""

import statistics


def read(rec):
    if rec["mix"]["driver"] != "stream" or len(rec["latencies_s"]) < 2:
        return None
    return 1e3 * statistics.quantiles(rec["latencies_s"], n=10, method="inclusive")[8]
