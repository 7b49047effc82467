"""The port's MoE layer (repro_torch.models.moe) against the reference.

The same weights (the reference's ``moe_params``, carried through numpy)
and the same numpy inputs go through ``repro.models.moe.moe_apply`` and
the port's, in f32 on the CPU: outputs and aux losses agree to 1e-5 (the
same arithmetic in another order) for sort and cumsum dispatch, with a
capacity that drops assignments and dropless, with and without shared
experts, and with padded experts.  Then port-side mirrors of
tests/test_moe.py (dropless equals a per-token gather, capacity drops are
monotone, aux losses bounded, padded experts never routed)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import unzip  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5
RNG = jax.random.PRNGKey(0)


def cfgs(E=8, k=2, shared=0, dispatch="sort"):
    """The same tiny f32 config in both packages."""
    kw = dict(d_model=32, d_ff=16, vocab=64, compute_dtype="float32")
    return (JModelConfig(moe=JMoEConfig(num_experts=E, top_k=k,
                                        num_shared_experts=shared,
                                        dispatch=dispatch), **kw),
            ModelConfig(moe=MoEConfig(num_experts=E, top_k=k,
                                      num_shared_experts=shared,
                                      dispatch=dispatch), **kw))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def params_pair(jcfg, e_pad=None):
    jp, _ = unzip(jmoe.moe_params(jcfg, RNG, ("moe",), e_pad=e_pad))
    return jp, _to_torch(jp)


def _x(B, S, seed, d=32):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("mode", ["dropless", "capacity", "tight"])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_matches_reference(dispatch, mode, shared):
    """``tight`` (capacity factor 0.5) drops about half the assignments:
    which ones is decided by the (token, choice) order of dispatch."""
    jcfg, cfg = cfgs(shared=shared, dispatch=dispatch)
    jp, tp = params_pair(jcfg)
    x = _x(2, 12, seed=1)
    kw = {"dropless": dict(dropless=True), "capacity": {},
          "tight": dict(capacity_factor=0.5)}[mode]
    jy, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), **kw)
    ty, taux = moe.moe_apply(cfg, tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for name in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=TOL, atol=TOL)


def test_padded_experts_match_reference():
    jcfg, cfg = cfgs(E=5, k=2)
    jp, tp = params_pair(jcfg, e_pad=8)
    x = _x(1, 16, seed=2)
    jy, _ = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), dropless=True)
    ty, _ = moe.moe_apply(cfg, tp, torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# port-side mirrors of tests/test_moe.py
# ---------------------------------------------------------------------------
def dense_gather_oracle(cfg, p, x2d):
    """Per-token gather of expert FFNs (no capacity)."""
    probs = torch.softmax(x2d @ p["router"], -1)
    w, idx = torch.topk(probs, cfg.moe.top_k)
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(x2d)
    for t in range(x2d.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(idx[t, j])
            g = x2d[t] @ p["wi_gate"][e]
            u = x2d[t] @ p["wi_up"][e]
            y[t] += w[t, j] * ((torch.nn.functional.silu(g) * u)
                               @ p["wo"][e])
    return y


@pytest.mark.parametrize("seed", range(5))
def test_dropless_equals_dense_gather(seed):
    _, cfg = cfgs()
    gen = torch.Generator().manual_seed(seed)
    p = moe.moe_params(cfg, gen)
    T = int(np.random.default_rng(seed).integers(4, 24))
    x = torch.from_numpy(_x(1, T, seed=seed))
    y, _ = moe.moe_apply(cfg, p, x, dropless=True)
    torch.testing.assert_close(y[0], dense_gather_oracle(cfg, p, x[0]),
                               rtol=1e-4, atol=1e-4)


def test_capacity_monotone_drops():
    """Raising the capacity factor monotonically increases the number of
    tokens whose output matches the dropless one; at high capacity the
    outputs are identical."""
    _, cfg = cfgs()
    p = moe.moe_params(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(1, 64, seed=3))
    y_full, _ = moe.moe_apply(cfg, p, x, dropless=True)

    def equal_rows(cf):
        y_cap, _ = moe.moe_apply(cfg, p, x, capacity_factor=cf)
        return int(((y_cap[0] - y_full[0]).abs() < 1e-5).all(-1).sum())

    counts = [equal_rows(cf) for cf in (0.25, 0.5, 1.0, 8.0)]
    assert counts == sorted(counts), counts
    assert counts[-1] == 64


def test_aux_losses_bounded():
    _, cfg = cfgs()
    p = moe.moe_params(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(2, 32, seed=4))
    _, aux = moe.moe_apply(cfg, p, x, dropless=True)
    # perfectly balanced load ⇒ lb = aux_coef; random ⇒ close to it
    assert 0.0 < float(aux["moe_lb"]) < 10 * cfg.moe.aux_coef
    assert float(aux["moe_z"]) >= 0.0


def test_padded_experts_masked():
    _, cfg = cfgs(E=5, k=2)
    p = moe.moe_params(cfg, torch.Generator().manual_seed(0), e_pad=8)
    x = torch.from_numpy(_x(1, 16, seed=5))
    seen = []
    orig = moe.router_dispatch

    def spy(logits, k, **kw):
        out = orig(logits, k, **kw)
        seen.append(out)
        return out
    moe.router_dispatch = spy
    try:
        y, _ = moe.moe_apply(cfg, p, x, dropless=True)
    finally:
        moe.router_dispatch = orig
    # routing never selects padded experts 5..7, and none is loaded
    assert int(seen[0].idx.max()) < 5
    assert float(seen[0].load[5:].sum()) == 0.0
    assert bool(torch.isfinite(y).all())
