"""Mean ms a training step waits for its rows from the data feed over
RPC, from the benchmark's span around ``DataFeedClient.get``."""
from benchlib.readers import span_mean


def read(run):
    return span_mean(run, "datafeed.wait_ms")
