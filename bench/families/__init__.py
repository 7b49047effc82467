"""What depends on a model's architecture, one module a family, found by
the configuration file's ``reference`` key (the file's family), beside
the family's plain reference ``bench/reference/<family>.py``.

A family module gives:

* ``shapes(cfg)``: (name, shape, scale) of each stacked seeded weight,
  in draw order (a scale of 0: a norm's scale, ones);
* ``port_tree(cfg, w)``: the port's parameter tree as views of them;
* ``port_checks(cfg, pc)``: (what, the file's, the port's) for each size
  and rule the file states, against the port's ``ModelConfig``;
* ``multiplied_params(cfg)`` and ``attn_pair_flops(cfg)``: the
  parameters a token multiplies, the head included, and the operations
  of one visible (query, key) pair over every layer (``counts.model``);
* ``decays(cfg, w)``: AdamW's weight decay for each stacked weight, as
  the port applies it (``reference.common.AdamW``);
* ``tiny(cfg)``: the file cut to the port's small CPU variant of its
  architecture (``preset: reduced``), for the benchmark's own tests;
* ``TINY_LIMITS``: the limits of such a cut cell, set from its readings
  on the CPU (a cell's own ``bench/tests/tiny_limits/<cell>.json`` goes
  before them).

There is no registry: a new family is two new files.
"""
from __future__ import annotations

import importlib


def of(cfg: dict):
    """The family module of the configuration file ``cfg``."""
    return importlib.import_module(f"{__name__}.{cfg['reference']}")
