"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``).  The library's file name carries
a hash of its source, of every local header it includes (``#include
"…"``, followed recursively) and of the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.  Nothing is built when a module is
imported: the first launch on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}
# nvcc's output per source (``-Xptxas -v``: registers, shared memory,
# spills), kept for whoever wants to print it
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); the "
                       "port's CUDA kernels are built from source")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_sources(src: Path) -> list:
    """``src`` and every local header it includes (``#include "…"``,
    relative to the including file), recursively, each once, in the
    order first reached.  A named header that does not exist is left to
    nvcc to report."""
    seen, todo = [], [Path(src).resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def _flags(defines=()) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def source_tag(src: Path, defines=()) -> str:
    """The library's tag: a hash of ``src``, its local headers (each by
    name and content) and the flags (``defines`` among them)."""
    h = hashlib.sha1(" ".join(_flags(defines)).encode())
    for path in local_sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:12]


def build(name: str, defines=()) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    raises with the compiler's output if the build fails.  ``defines``
    (macro names, ``-D``) select a diagnostic build of a source; the main
    path never passes any."""
    src = CSRC / f"{name}.cu"
    tag = source_tag(src, defines)
    out = BUILD_DIR / f"lib{name}-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_flags(defines), "-o", str(tmp),
                           str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)                # atomic: concurrent builds agree
    return out


def build_all(names: Iterable[str]) -> None:
    """Compile several sources at once, one ``nvcc`` process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for done in [pool.submit(build, name) for name in names]:
            done.result()


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines``),
    built if needed."""
    key = (name,) + tuple(defines)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(str(build(name, defines)))
        return lib
