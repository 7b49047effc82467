"""The attention calls' least time (forward and backward) by the frozen
count over the attention kernels' device time in the trace, percent."""
from benchlib.readers import roofline


def read(run):
    return roofline(run, "attention")
