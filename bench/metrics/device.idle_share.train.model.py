"""Share of the traced window in which the device ran nothing while the
program was inside a ``train.forward`` or ``train.backward`` region,
percent: the model's part of ``device.idle_share.train``."""
from benchlib.regions import idle_parts


def read(run):
    parts = idle_parts(run)
    return None if parts is None else parts["model"]
