"""The router's backward and the MoE layer's gradients in the port
(repro_torch.kernels.moe_router, repro_torch.models.moe).

On the CPU: ``router_bwd_plain`` (the logits' gradient from those of the
combine weights w and the aux sums prob_sum and z_sum) against autograd
through ``router_dispatch_plain`` and against ``jax.grad`` of the
reference's router (``ref.router_topk_ref``, its renormalisation and the
aux sums of ``models/moe.py``), on the same numpy logits and upstream
gradients, to 1e-5 of the largest entry (f32 on both sides, summed in
another order).  Cases: drops (the capacity does not touch the gradient),
padded experts (their logits get none), exact ties (the gradient goes to
the lower index, which the forward took) and near-ties.  ``router_dispatch``
with logits that need a gradient goes through ``RouterFunction``.  The MoE
layer in train mode (drops over capacity) against ``jax.grad`` of the
reference's ``moe_apply``: every parameter's and the input's gradient;
its dispatch backward (a gather in choice order, no ``index_add_``) gives
bitwise-equal gradients on two runs.  On the card (``-m gpu``): the
backward kernel against the plain version.

The card's machine has no JAX, so JAX is imported by fixtures and not at
the top."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.kernels import moe_router as kr  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5
# name, T, E, k, n_real, capacity, logits: "normal", "ties" (values on a
# grid of 0.5: many exact ties) or "near" (pairs 1e-6 apart)
CASES = [
    ("granite-T64-drops", 64, 40, 8, 40, 13, "normal"),
    ("granite-T4", 4, 40, 8, 40, 4, "normal"),
    ("padded-E48-real40", 64, 48, 8, 40, 13, "normal"),
    ("k1", 32, 16, 1, 16, 2, "normal"),
    ("ties", 48, 16, 4, 16, 12, "ties"),
    ("near-ties", 48, 16, 4, 12, 12, "near"),
]


def _inputs(case, seed=0):
    """Logits (T, E) and upstream gradients dw (T, k), dprob_sum (E,),
    dz_sum (), as numpy f32."""
    _, T, E, k, _, _, kind = case
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.integers(-4, 4, (T, E)) * 0.5
    elif kind == "near":
        x = rng.standard_normal((T, E // 2))
        x = np.repeat(x, 2, axis=1)
        x[:, 1::2] += 1e-6
    else:
        x = rng.standard_normal((T, E))
    f32 = np.float32
    return (x.astype(f32), rng.standard_normal((T, k)).astype(f32),
            rng.standard_normal(E).astype(f32),
            np.asarray(rng.standard_normal(), f32))


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def _autograd(logits, dw, dps, dz, k, n_real, capacity, plain=True):
    """The logits' gradient by autograd through the plain routing (or
    through ``router_dispatch``), and the routing."""
    x = logits.clone().requires_grad_()
    route = kr.router_dispatch_plain if plain else kr.router_dispatch
    r = route(x, k, n_real=n_real, capacity=capacity)
    loss = (r.w * dw).sum() + (r.prob_sum * dps).sum() + r.z_sum * dz
    g, = torch.autograd.grad(loss, x)
    return g, r


def _close(got, want, tol=TOL):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_autograd(case):
    _, T, E, k, n_real, C, _ = case
    logits, dw, dps, dz = _t(*_inputs(case))
    want, r = _autograd(logits, dw, dps, dz, k, n_real, C)
    got = kr.router_bwd_plain(logits, r.probs.detach(), r.idx,
                              r.w.detach(), dw, dps, dz, n_real=n_real)
    _close(got, want)
    assert not got[:, n_real:].any()        # padded experts: no gradient


@pytest.fixture(scope="module")
def jax_router():
    """The reference's router and aux sums as one function of the logits,
    and its gradient: masked logits (-1e30 past n_real, as
    ``models/moe.py``), ``ref.router_topk_ref``, prob_sum and z_sum."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ref import router_topk_ref

    def grad(logits, dw, dps, dz, k, n_real):
        E = logits.shape[1]

        def f(x):
            x = jnp.where(jnp.arange(E)[None] >= n_real, -1e30, x)
            w, idx, probs = router_topk_ref(x, k)
            z = jnp.square(jax.nn.logsumexp(x, axis=-1)).sum()
            return (w * dw).sum() + (probs.sum(0) * dps).sum() + z * dz, idx
        g, idx = jax.grad(f, has_aux=True)(jnp.asarray(logits))
        return np.asarray(g), np.asarray(idx)
    return grad


@pytest.mark.parametrize("case", [c for c in CASES if c[-1] != "near"],
                         ids=lambda c: c[0])
def test_plain_backward_matches_jax(jax_router, case):
    """Exact ties too: both sides pick the lower index, and the gradient
    follows the pick (near-ties are held to autograd only: each side's
    softmax may round a 1e-6 gap its own way)."""
    _, T, E, k, n_real, C, _ = case
    arrays = _inputs(case)
    want, want_idx = jax_router(*arrays, k, n_real)
    logits, dw, dps, dz = _t(*arrays)
    r = kr.router_dispatch_plain(logits, k, n_real=n_real, capacity=C)
    np.testing.assert_array_equal(r.idx.numpy(), want_idx)
    got = kr.router_bwd_plain(logits, r.probs, r.idx, r.w, dw, dps, dz,
                              n_real=n_real)
    _close(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: c[0])
def test_router_function_carries_the_gradient(case):
    """router_dispatch with logits that need a gradient: RouterFunction,
    the same routing, w / prob_sum / z_sum differentiable and the rest
    not, and autograd through the plain version's gradient."""
    _, T, E, k, n_real, C, _ = case
    logits, dw, dps, dz = _t(*_inputs(case))
    got, r = _autograd(logits, dw, dps, dz, k, n_real, C, plain=False)
    want, p = _autograd(logits, dw, dps, dz, k, n_real, C)
    assert type(r.w.grad_fn).__name__ == "RouterFunctionBackward"
    assert [t.requires_grad for t in r] == [True, False, False, False,
                                            False, False, True, True]
    for a, b in zip(r[1:6], p[1:6]):
        assert torch.equal(a, b)
    _close(got, want)
    assert kr.router_bwd.launches == 0      # CPU: no kernel launched


def test_missing_upstream_gradients_read_as_zero():
    """A loss of w alone: prob_sum's and z_sum's gradients are None."""
    case = CASES[0]
    _, T, E, k, n_real, C, _ = case
    logits, dw, _, _ = _t(*_inputs(case))
    x = logits.clone().requires_grad_()
    r = kr.router_dispatch(x, k, n_real=n_real, capacity=C)
    got, = torch.autograd.grad((r.w * dw).sum(), x)
    want = kr.router_bwd_plain(logits, r.probs, r.idx, r.w.detach(), dw,
                               torch.zeros(E), torch.zeros(()),
                               n_real=n_real)
    _close(got, want)


def test_backward_launch_checks_before_building():
    """The backward's launch validates its inputs before it builds or
    binds anything (so the check runs here, on CPU tensors)."""
    logits, dw, dps, dz = _t(*_inputs(CASES[0]))
    r = kr.router_dispatch_plain(logits, 8, n_real=40, capacity=13)
    built = kr._bwd_fn
    with pytest.raises(ValueError, match="idx"):
        kr._router_bwd_cuda(logits, r.probs, r.idx[:, :3], r.w, dw, dps,
                            dz, n_real=40)
    with pytest.raises(ValueError, match="int32"):
        kr._router_bwd_cuda(logits, r.probs, r.idx.long(), r.w, dw, dps,
                            dz, n_real=40)
    assert kr._bwd_fn is built


# ---------------------------------------------------------------------------
# the MoE layer in train mode
# ---------------------------------------------------------------------------
def _cfgs(E=8, k=2, dispatch="sort"):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import MoEConfig as JMoEConfig
    kw = dict(d_model=32, d_ff=16, vocab=64, compute_dtype="float32")
    return (JModelConfig(moe=JMoEConfig(num_experts=E, top_k=k,
                                        dispatch=dispatch), **kw),
            ModelConfig(moe=MoEConfig(num_experts=E, top_k=k,
                                      dispatch=dispatch), **kw))


def _layer_grads(cfg, params, x, dy, cf):
    """(y, gradients of x and of each parameter) of the port's layer in
    train mode (capacity factor ``cf``), loss = sum(y dy) + aux."""
    tp = {k: v.clone().requires_grad_() for k, v in params.items()}
    tx = x.clone().requires_grad_()
    y, aux = moe.moe_apply(cfg, tp, tx, capacity_factor=cf)
    loss = (y * dy).sum() + aux["moe_lb"] + aux["moe_z"]
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tx] + [tp[n] for n in names])
    return y.detach(), dict(zip(["x"] + names, grads))


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_layer_gradients_match_reference(dispatch, cf):
    """Train mode at the config's 1.25 and a tight 0.5 (about half the
    assignments dropped): y, and the gradients of x, the router and the
    experts' weights, against jax.grad of the reference's moe_apply."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models import moe as jmoe
    from repro.models.common import unzip
    jcfg, cfg = _cfgs(dispatch=dispatch)
    jp, _ = unzip(jmoe.moe_params(jcfg, jax.random.PRNGKey(0), ("moe",)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    dy = rng.standard_normal((2, 24, 32)).astype(np.float32)

    def f(p, xx):
        y, aux = jmoe.moe_apply(jcfg, p, xx, capacity_factor=cf)
        return (y * dy).sum() + aux["moe_lb"] + aux["moe_z"], y
    (_, jy), (jg, jgx) = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(jp, jnp.asarray(x))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    y, got = _layer_grads(cfg, params, torch.from_numpy(x),
                          torch.from_numpy(dy), cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    want = {"x": jgx, **jg}
    for name, g in got.items():
        _close(g, torch.from_numpy(np.array(want[name])), tol=1e-4)


def test_moe_dispatch_backward_is_deterministic():
    """Two runs of the train-mode layer's backward from one seed give
    bitwise-equal gradients (the dispatch's backward is a gather summed
    in choice order; the combine's scatters to distinct slots)."""
    _, cfg = _cfgs(E=8, k=4)
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_params(cfg, gen)
    x = torch.randn(2, 32, 32, generator=gen)
    dy = torch.randn(2, 32, 32, generator=gen)
    runs = [_layer_grads(cfg, params, x, dy, 1.25)[1] for _ in range(2)]
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name


def test_kept_assignments_hold_distinct_slots():
    """What makes the combine's backward scatter order-free: every kept
    assignment has a slot of its own, and each slot's token is the one
    whose assignment holds it."""
    logits = torch.from_numpy(_inputs(CASES[0])[0])
    T, E, k, C = 64, 40, 8, 13
    r = kr.router_dispatch_plain(logits, k, n_real=E, capacity=C)
    kept = r.slot[r.slot < E * C].long()
    assert kept.numel() == torch.unique(kept).numel()
    tokens = torch.arange(T)[:, None].expand(T, k)[r.slot < E * C]
    assert torch.equal(r.src.long()[kept], tokens)
    assert (r.slot == E * C).any()          # the case drops


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + [
    ("granite-T1024", 1024, 40, 8, 40, 256, "normal")], ids=lambda c: c[0])
def test_bwd_kernel_matches_plain_on_card(case):
    _card()
    _, T, E, k, n_real, C, _ = case
    logits, dw, dps, dz = _t(*_inputs(case), device="cuda")
    r = kr.router_dispatch(logits, k, n_real=n_real, capacity=C)
    before = kr.router_bwd.launches
    got = kr.router_bwd(logits, r.probs, r.idx, r.w, dw, dps, dz,
                        n_real=n_real)
    torch.cuda.synchronize()
    assert kr.router_bwd.launches == before + 1
    want = kr.router_bwd_plain(logits, r.probs, r.idx, r.w, dw, dps, dz,
                               n_real=n_real)
    _close(got, want)
    again = kr.router_bwd(logits, r.probs, r.idx, r.w, dw, dps, dz,
                          n_real=n_real)
    assert torch.equal(got, again)          # no atomics: run to run equal


@pytest.mark.gpu
def test_router_function_launches_the_backward_on_card():
    _card()
    _, T, E, k, n_real, C, _ = CASES[0]
    logits, dw, dps, dz = _t(*_inputs(CASES[0]), device="cuda")
    before = (kr.router_dispatch.launches, kr.router_bwd.launches)
    got, _ = _autograd(logits, dw, dps, dz, k, n_real, C, plain=False)
    torch.cuda.synchronize()
    assert (kr.router_dispatch.launches, kr.router_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want, _ = _autograd(logits, dw, dps, dz, k, n_real, C)
    _close(got, want)
