"""Useful operations of the training steps completed in the traced
run's plain part (6 a parameter a token and 3x attention's pairs,
``counts.model``) over its seconds at the bf16 peak, percent."""
from benchlib.readers import mfu


def read(run):
    return mfu(run)
