"""The port's sharding resolver (``repro_torch.distrib.sharding``) and
logical axes (``Model.param_axes``, ``init_state_axes``) against the
reference's.

For every config at full width: ``Model.param_axes()`` equals the axes the
reference's ``unzip`` gives each parameter, less the leading ``"layers"``
of its stacked layers (the port keeps each layer apart); and on meshes
(16, 16), (2, 16, 16), (2, 2), (4, 1) and (1, 4) every parameter's spec
equals the reference's ``tree_specs`` (the stacked layers' leading
``None`` dropped) and ``bytes_per_device`` of the AdamW state (params,
m, v and the count) equals the reference's.  The reference's trees come
from ``jax.eval_shape`` and the port's from meta tensors: nothing is
allocated.  Then the reference's own resolver cases
(``tests/test_distrib.py``) on the port's ``spec_for``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.distrib import sharding as rs  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro.train.step import init_state_axes as r_state_axes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distrib import sharding as ps  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import init_state_axes, leaves_of  # noqa: E402

ARCHS = sorted(rconfigs.names())
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


def _port_order(tree, unstack, model):
    """A reference parameter tree laid out as the port's: prefix layers,
    then each stacked period's layer j for every j (``unstack`` maps a
    stacked leaf to one layer's), then the trailing layers; an
    encoder-decoder's stacked encoder as its list of layers."""
    def each(t):
        if isinstance(t, dict):
            return {k: each(v) for k, v in t.items()}
        return unstack(t)
    layers = list(tree.get("prefix", ()))
    for _ in range(model.n_scan_periods):
        layers += [each(period) for period in tree["periods"]]
    layers += list(tree["trailing"])
    out = {"embed": tree["embed"], "layers": layers,
           "final_norm": tree["final_norm"]}
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"layers": [each(enc["stack"])]
                          * model.cfg.n_enc_layers,
                          "final_norm": enc["final_norm"]}
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch):
    model = RModel(rconfigs.get(arch))
    values, axes = r_state_axes(model, roptim.OptConfig())
    return model, values, axes


@functools.lru_cache(maxsize=None)
def _port(arch):
    model = Model(configs.get(arch))
    shapes, axes = init_state_axes(model, optim.OptConfig())
    return model, shapes, axes


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch):
    rmodel, _, raxes = _reference(arch)
    model, shapes, axes = _port(arch)
    want = _port_order(raxes["params"], lambda a: tuple(a)[1:], rmodel)
    assert [tuple(a) for a in leaves_of(want)] == \
        [tuple(a) for a in leaves_of(model.param_axes())]
    # the same places as the parameters, and one name a dimension
    for t, a in zip(leaves_of(shapes["params"]), leaves_of(axes["params"])):
        assert t.ndim == len(a)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_bytes_match_reference(arch, mesh):
    shape, names = MESHES[mesh]
    rmodel, rvalues, raxes = _reference(arch)
    model, shapes, axes = _port(arch)
    rmesh = rs.abstract_mesh(shape, names)
    pmesh = ps.abstract_mesh(shape, names)
    rspecs = rs.tree_specs(rvalues["params"], raxes["params"], rmesh)
    want = _port_order(rspecs, lambda s: tuple(s)[1:], rmodel)
    got = ps.tree_specs(shapes["params"], axes["params"], pmesh)
    assert [tuple(s) for s in leaves_of(want)] == leaves_of(got)
    assert ps.bytes_per_device(shapes, axes, pmesh) == \
        rs.bytes_per_device(rvalues, raxes, rmesh)


def _both(shape_, axes_, mesh_shape, mesh_axes, rules=None):
    rmesh = rs.abstract_mesh(mesh_shape, mesh_axes)
    pmesh = ps.abstract_mesh(mesh_shape, mesh_axes)
    rrules = rs.merge_rules(rs.DEFAULT_RULES, rules)
    prules = ps.merge_rules(ps.DEFAULT_RULES, rules)
    return (tuple(rs.spec_for(shape_, axes_, rmesh, rrules)),
            ps.spec_for(shape_, axes_, pmesh, prules))


@pytest.mark.parametrize("case", [
    ((1024, 16, 64), ("embed", "heads", "head_dim"), (16, 16), None,
     ("data", "model")),
    ((1024, 8, 64), ("embed", "kv_heads", "head_dim"), (16, 16), None,
     ("data",)),
    ((49155, 1536), ("vocab", "embed"), (16, 16), None, (None, "data")),
    ((151936, 1024), ("vocab", "embed"), (16, 16), None, ("model", "data")),
    ((4096, 16384), ("embed", "mlp"), (2, 16, 16), None,
     (("pod", "data"), "model")),
    ((1, 524288, 1, 256), ("batch", "kv_seq", "kv_heads", "head_dim"),
     (2, 16, 16), {"kv_seq": ("data", "model")}, (None, ("data", "model"))),
    ((32, 32), ("a", "b"), (16, 16), {"a": ("model",), "b": ("model",)},
     ("model",))], ids=str)
def test_spec_for_reference_cases(case):
    shape_, axes_, mshape, rules, want = case
    names = ("data", "model") if len(mshape) == 2 else ("pod", "data",
                                                        "model")
    ref, got = _both(shape_, axes_, mshape, names, rules)
    assert got == ref == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tree_shardings_carry_the_specs(mesh):
    shape, names = MESHES[mesh]
    pmesh = ps.abstract_mesh(shape, names)
    model, shapes, axes = _port("granite-moe-3b-a800m")
    got = leaves_of(ps.tree_shardings(shapes, axes, pmesh))
    want = leaves_of(ps.tree_specs(shapes, axes, pmesh))
    assert [g.spec for g in got] == want
    assert all(g.mesh is pmesh for g in got)


@pytest.mark.parametrize("seed", range(5))
def test_bytes_per_device_of_a_matrix(seed):
    rng = np.random.default_rng(seed)
    d, f = int(rng.integers(1, 8)) * 16, int(rng.integers(1, 8)) * 16
    mesh = ps.abstract_mesh((4, 4), ("data", "model"))
    tree = {"w": torch.empty((d, f), device="meta")}
    assert ps.bytes_per_device(tree, {"w": ("embed", "mlp")}, mesh) == \
        d * f * 4 // 16
