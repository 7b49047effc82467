"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke`` loads neither ``jax`` nor anything of ``repro``, and the
entry points refuse to run on the CPU unless asked to."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), leaked)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.split(maxsplit=1)
    assert int(n) >= 30, out.stdout          # every module was imported
    assert leaked.strip() == "[]", f"port imported {leaked}"


def test_chip_smoke_sweep_is_the_reference_sweep():
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from test_kernels import ATTN_SWEEP
    assert chip_smoke.ATTN_SWEEP == ATTN_SWEEP


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
                 lambda: serve.main(["--reduced", "--demo"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
