"""Share of the traced window in which the device ran nothing while the
program was inside a ``train.optimizer`` region, percent: the
optimizer's part of ``device.idle_share.train``."""
from benchlib.regions import idle_parts


def read(run):
    parts = idle_parts(run)
    return None if parts is None else parts["optimizer"]
