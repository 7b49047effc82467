"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke`` loads neither ``jax`` nor anything of ``repro`` nor
``ml_dtypes`` (the card's machine has none), and the entry points refuse
to run on the CPU unless asked to."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m in ("jax", "repro", "ml_dtypes")
                or m.startswith(("jax.", "repro.", "ml_dtypes.")))
print(json.dumps({"names": names, "leaked": leaked}))
"""
# the kernels and blocks of each slice, which the walk must have reached
SLICE_MODULES = {
    "repro_torch.kernels.attention", "repro_torch.kernels.moe_router",
    "repro_torch.kernels.moe_combine", "repro_torch.kernels.fletcher", "repro_torch.kernels.ssd",
    "repro_torch.kernels.rglru", "repro_torch.models.ssd_block",
    "repro_torch.models.rglru_block", "repro_torch.models.moe",
    "repro_torch.services.checkpoint", "repro_torch.fabric.pool",
    "repro_torch.fabric.affinity", "repro_torch.services.membership",
    "repro_torch.analysis.lockdep", "repro_torch.train.optim",
    "repro_torch.train.step", "repro_torch.data.pipeline",
    "repro_torch.launch.train",
    # the encoder-decoder and VLM slice: the models with their frontends,
    # encoder and cross attention, serving and the services found by name
    "repro_torch.models.transformer", "repro_torch.models.attention",
    "repro_torch.models.bridge", "repro_torch.models.common",
    "repro_torch.serve.engine", "repro_torch.services.gateway",
    "repro_torch.services.datafeed", "repro_torch.fabric.registry",
    # distribution: the resolver, the mesh, collectives and the pipeline
    "repro_torch.distrib", "repro_torch.distrib.sharding",
    "repro_torch.distrib.collectives", "repro_torch.distrib.pipeline",
    "repro_torch.launch.mesh",
    # tensor parallelism: the sharded step's layout of the layers
    "repro_torch.distrib.tensor_parallel",
    # the dry run and the kernels' work it counts
    "repro_torch.launch.dryrun", "repro_torch.kernels.cost"}


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["names"]) >= 83, got["names"]   # every module imported
    assert SLICE_MODULES <= set(got["names"])
    assert got["leaked"] == [], f"port imported {got['leaked']}"


def test_chip_smoke_sweep_is_the_reference_sweep():
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from test_kernels import ATTN_SWEEP, RGLRU_SWEEP, SSD_SWEEP
    assert chip_smoke.ATTN_SWEEP == ATTN_SWEEP
    assert chip_smoke.SSD_SWEEP == SSD_SWEEP
    assert chip_smoke.RGLRU_SWEEP == RGLRU_SWEEP


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine
    cfg = configs.reduced("qwen1.5-0.5b")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    for call in (lambda: model.init(0),
                 lambda: ServeEngine(model, params),
                 lambda: serve.main(["--reduced", "--demo"]),
                 lambda: serve.main(["--arch", "mamba2-1.3b", "--reduced",
                                     "--demo"]),
                 lambda: serve.main(["--arch", "recurrentgemma-9b",
                                     "--reduced", "--demo"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
