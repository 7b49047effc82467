"""Device time of the operations launched inside the optimizer's
update over that of the operations launched inside the training steps,
in the trace, percent."""
from benchlib.readers import share, traced


def read(run):
    if not traced(run):
        return None
    return share(run, "train.optimizer_device_s", "train.step_device_s")
