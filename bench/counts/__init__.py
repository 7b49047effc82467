"""The benchmark's frozen yardstick: the card's peaks, each kernel's
operations and bytes from its shapes, and a model's useful operations.
Copied from the program's reckoning once and kept here, so that a change
to the program cannot change what its work is counted as."""
