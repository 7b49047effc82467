"""The port's ``ModelConfig`` for a configuration file, and a check that
the two state the same model.

A configuration file holds its source's keys (Hugging Face names) as the
cell runs them, its family under ``reference``, and under ``port`` the
port's name for the architecture and the dtypes it is served or trained
in (``preset: reduced`` takes the port's small CPU variant of it, for
the benchmark's own tests).  ``port_config`` takes the port's published
config of that name, sets the depth and dtypes, and fails unless the
family's checks (``families.<family>.port_checks``) find every size and
every stated rule the file gives to be the port's, and the port's model
one the reference models: a file that says one model while the port
runs another is refused before any run.
"""
from __future__ import annotations

import families


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for the configuration file ``cfg``."""
    from repro_torch import configs
    port = cfg["port"]
    base = (configs.reduced if port.get("preset") == "reduced"
            else configs.get)(port["arch"])
    pc = base.replace(
        n_layers=cfg["num_hidden_layers"],
        param_dtype=port["param_dtype"],
        compute_dtype=port["compute_dtype"])
    wrong = [(k, a, b) for k, a, b in families.of(cfg).port_checks(cfg, pc)
             if a != b]
    if wrong:
        raise ValueError(f"{cfg['name']}: the file and the port's "
                         f"{port['arch']} differ: {wrong}")
    return pc
