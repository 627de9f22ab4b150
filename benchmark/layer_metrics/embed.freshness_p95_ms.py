"""``embed.freshness_p95_ms``: the 95th percentile of what
``embed.freshness_p50_ms`` reads, over the same writes: the tail a
catalog's users see when writes queue behind one another."""

from benchmark.layer_metrics._common import freshness_ms, percentile


def read(run):
    return percentile(freshness_ms(run), 95)
