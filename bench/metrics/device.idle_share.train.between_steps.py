"""Share of the traced window in which the device ran nothing and the
program was outside every ``train.step`` region (the next rows' fetch,
their copy to the card, the loss's read), percent: the training loop's
part of ``device.idle_share.train``."""
from benchlib.regions import idle_parts


def read(run):
    parts = idle_parts(run)
    return None if parts is None else parts["between_steps"]
