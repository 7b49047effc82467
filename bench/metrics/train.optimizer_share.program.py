"""Device time of the operations launched inside the program's
``train.optimizer`` regions over that of the operations launched inside
its ``train.step`` regions, in the trace, percent."""
from benchlib.regions import launched_share


def read(run):
    return launched_share(run, "train.optimizer", "train.step")
