"""``window.freshness_p50_ms``: the median over every write due in the
traced run's window of the time from its due time to the first moment a
read of the maintained table would return its effect (host clock; the
later of the moment the harness saw the write APPLIED and the
completion of the CUDA event it then recorded on the program's
stream). The traced run samples every ticket, which adds to the host's
time a tick."""

from benchmark.layer_metrics._common import freshness_ms, percentile


def read(run):
    return percentile(freshness_ms(run), 50)
