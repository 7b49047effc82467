"""The port's kernel build (repro_torch.kernels.build): which files a
library's tag covers.

A library is named by a hash of its ``.cu``, of every local header the
``.cu`` includes (``#include "…"``, followed recursively, relative to the
including file) and of nvcc's flags, so that an edited header rebuilds
every library that includes it.  Nothing here runs nvcc: the tags are
computed from files in a temporary directory."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import SOURCES, build  # noqa: E402


def _tree(tmp_path):
    """a.cu includes inc/b.cuh (and a system header), which includes
    c.cuh beside it; d.cuh is included by nothing."""
    (tmp_path / "inc").mkdir()
    (tmp_path / "a.cu").write_text(
        '#include <cuda_runtime.h>\n#include "inc/b.cuh"\n'
        'int main() { return b(); }\n')
    (tmp_path / "inc" / "b.cuh").write_text(
        '#pragma once\n  #  include "c.cuh"\ninline int b() { return c(); }\n')
    (tmp_path / "inc" / "c.cuh").write_text(
        '#pragma once\ninline int c() { return 1; }\n')
    (tmp_path / "d.cuh").write_text('inline int d() { return 2; }\n')
    return tmp_path / "a.cu"


def test_local_sources_follow_includes_recursively(tmp_path):
    src = _tree(tmp_path)
    got = [p.relative_to(tmp_path).as_posix()
           for p in build.local_sources(src)]
    assert got == ["a.cu", "inc/b.cuh", "inc/c.cuh"]


@pytest.mark.parametrize("edited", ["a.cu", "inc/b.cuh", "inc/c.cuh"])
def test_editing_an_included_file_moves_the_tag(tmp_path, edited):
    src = _tree(tmp_path)
    before = build.source_tag(src)
    path = tmp_path / edited
    path.write_text(path.read_text() + "// edited\n")
    assert build.source_tag(src) != before


def test_unrelated_edit_keeps_the_tag(tmp_path):
    src = _tree(tmp_path)
    before = build.source_tag(src)
    (tmp_path / "d.cuh").write_text("inline int d() { return 3; }\n")
    (tmp_path / "e.cu").write_text('#include "inc/c.cuh"\n')
    assert build.source_tag(src) == before


def test_include_cycle_is_followed_once(tmp_path):
    (tmp_path / "x.cu").write_text('#include "y.cuh"\n')
    (tmp_path / "y.cuh").write_text('#include "z.cuh"\n')
    (tmp_path / "z.cuh").write_text('#include "y.cuh"\n')
    names = [p.name for p in build.local_sources(tmp_path / "x.cu")]
    assert names == ["x.cu", "y.cuh", "z.cuh"]
    assert build.source_tag(tmp_path / "x.cu")


def test_rglru_libraries_build_from_the_shared_header():
    """The RG-LRU's forward and backward include one header, so an edit
    of it rebuilds both libraries; every source's tag covers its .cu."""
    for name in ("rglru_scan", "rglru_bwd"):
        names = [p.name for p in build.local_sources(
            build.CSRC / f"{name}.cu")]
        assert names == [f"{name}.cu", "rglru_common.cuh"], names
    for name in SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert len(build.source_tag(build.CSRC / f"{name}.cu")) == 12


def test_router_libraries_build_from_the_shared_header():
    """The router's backward and the MoE combine's include one header
    (the logits' row gradient), so an edit of it rebuilds both."""
    for name in ("moe_router", "moe_combine"):
        names = [p.name for p in build.local_sources(
            build.CSRC / f"{name}.cu")]
        assert names == [f"{name}.cu", "moe_router_common.cuh"], names
