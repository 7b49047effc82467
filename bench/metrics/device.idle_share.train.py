"""Share of the traced window with no operation on the device,
percent."""
from benchlib.readers import idle


def read(run):
    return idle(run, "device.busy_s", "device.window_s")
