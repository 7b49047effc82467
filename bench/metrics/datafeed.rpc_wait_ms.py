"""Mean ms of the traced window's ``datafeed.wait`` regions: the
program's own span of a step's block on the data feed's RPC."""
from benchlib.regions import mean_ms


def read(run):
    return mean_ms(run, "datafeed.wait")
