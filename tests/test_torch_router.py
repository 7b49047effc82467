"""The port's MoE routing and dispatch (repro_torch.kernels.moe_router).

On the CPU: the plain top-k against the Pallas kernel in interpret
mode and against ``ref.router_topk_ref`` on the same numpy logits, over
the reference's (T, E) x k grid (tests/test_kernels.py) plus granite's
(64, 40, 8) and deepseek's (64, 64, 6): indices exactly equal, weights
and probabilities within rtol 1e-5 / atol 1e-6 (f32 on both sides, sums
in another order).  Ties go to the lowest expert index.  The plain
dispatch (both of the reference's forms) against a numpy loop that
counts each expert's assignments in (token, choice) order: slots, slot
tokens and loads exactly equal, dropless, at capacity factor 1.25 and at
a capacity that drops, with and without padded experts; the aux sums
against f64 sums at rtol 1e-5.  The kernel's raw launch refuses logits
that need a gradient (``RouterFunction`` carries those) before it builds
anything.  On the card (``-m gpu``):
the hand-written kernel against the plain version.

The card's machine has no JAX, so JAX is imported by the ``ref``
fixture and not at the top."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_router as kr  # noqa: E402
from repro_torch.kernels.moe_router import (router_dispatch,  # noqa: E402
                                            router_dispatch_plain,
                                            router_topk, router_topk_plain)

RTOL, ATOL = 1e-5, 1e-6
# tests/test_kernels.py's grid (k > E skipped there), then granite and
# deepseek at a 64-token chunk
CASES = [((T, E), k) for (T, E) in [(32, 8), (100, 16), (256, 40)]
         for k in (1, 2, 6)] + [((64, 40), 8), ((64, 64), 6)]


def _logits(T, E, seed=0):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as ref_mod
    from repro.kernels.moe_router import router_topk_pallas
    return SimpleNamespace(jnp=jnp, oracle=ref_mod.router_topk_ref,
                           pallas=router_topk_pallas)


@pytest.mark.parametrize("TE,k", CASES, ids=lambda c: str(c))
def test_plain_matches_reference(ref, TE, k):
    T, E = TE
    x = _logits(T, E)
    w, idx, probs = router_topk_plain(torch.from_numpy(x), k)
    for want_w, want_i, want_p in (
            ref.oracle(ref.jnp.asarray(x), k),
            ref.pallas(ref.jnp.asarray(x), k, interpret=True, block_t=32)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(w.numpy(), np.asarray(want_w),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(probs.numpy(), np.asarray(want_p),
                                   rtol=RTOL, atol=ATOL)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32


def test_ties_go_to_the_lowest_index(ref):
    """Equal logits (and the padded experts' -1e30) give equal
    probabilities; every version takes them in ascending index order."""
    x = np.zeros((3, 8), np.float32)
    x[1, [2, 5, 6]] = 1.0
    x[2, 5:] = -1e30
    w, idx, _ = router_topk_plain(torch.from_numpy(x), 4)
    assert idx.tolist() == [[0, 1, 2, 3], [2, 5, 6, 0], [0, 1, 2, 3]]
    _, want, _ = ref.pallas(ref.jnp.asarray(x), 4, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_dispatch_by_device():
    """A CPU tensor takes the plain version and counts no launch; a
    device without a kernel raises."""
    x = torch.from_numpy(_logits(8, 40))
    before = router_dispatch.launches
    got = router_topk(x, 8)
    for a, b in zip(got, router_topk_plain(x, 8)):
        assert torch.equal(a, b)
    got = router_dispatch(x, 8, n_real=36, capacity=3)
    for a, b in zip(got, router_dispatch_plain(x, 8, n_real=36,
                                               capacity=3)):
        assert torch.equal(a, b)
    assert router_dispatch.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        router_topk(x.to("meta"), 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        router_dispatch(x.to("meta"), 8, n_real=40, capacity=8)


# ---------------------------------------------------------------------------
# dispatch: slots, slot tokens, loads and the aux sums
# ---------------------------------------------------------------------------
def count_in_order(idx, n_experts, capacity):
    """The numpy oracle: walk the assignments in (token, choice) order,
    counting each expert's; a count at or past ``capacity`` is a drop."""
    T, k = idx.shape
    count = np.zeros(n_experts, np.int64)
    slot = np.full((T, k), n_experts * capacity, np.int64)
    src = np.full(n_experts * capacity, T, np.int64)
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j])
            if count[e] < capacity:
                slot[t, j] = e * capacity + count[e]
                src[slot[t, j]] = t
            count[e] += 1
    return slot, src, count.astype(np.float32)


def aux_sums_f64(logits, n_real):
    """(prob_sum, z_sum) in f64 of the masked logits."""
    x = logits.astype(np.float64)
    x[:, n_real:] = -1e30
    m = x.max(-1, keepdims=True)
    e = np.exp(x - m)
    lse = m[:, 0] + np.log(e.sum(-1))
    return (e / e.sum(-1, keepdims=True)).sum(0), float((lse ** 2).sum())


def capacity_of(mode, T, E, k):
    cf = {"dropless": None, "cf1.25": 1.25, "tight": 0.5}[mode]
    return T if cf is None else max(int(np.ceil(T * k / E * cf)), 1)


@pytest.mark.parametrize("Ek", [(8, 2), (40, 8), (64, 1)], ids=str)
@pytest.mark.parametrize("T", [1, 5, 64, 300])
@pytest.mark.parametrize("padded", [False, True], ids=["real", "padded"])
@pytest.mark.parametrize("mode", ["dropless", "cf1.25", "tight"])
@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
def test_dispatch_plain_matches_count(dispatch, mode, padded, T, Ek):
    E, k = Ek
    e_pad = E + 3 if padded else E
    C = capacity_of(mode, T, E, k)
    x = _logits(T, e_pad, seed=T + E)
    r = router_dispatch_plain(torch.from_numpy(x), k, n_real=E,
                              capacity=C, dispatch=dispatch)
    idx = r.idx.numpy()
    assert idx.max() < E                    # padded experts never picked
    slot, src, load = count_in_order(idx, e_pad, C)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.src.numpy(), src)
    np.testing.assert_array_equal(r.load.numpy(), load)
    assert r.slot.dtype == r.src.dtype == torch.int32
    assert r.load.dtype == r.prob_sum.dtype == r.z_sum.dtype == torch.float32
    prob_sum, z_sum = aux_sums_f64(x, E)
    np.testing.assert_allclose(r.prob_sum.numpy(), prob_sum, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(r.z_sum), z_sum, rtol=1e-5)
    # the routing itself is the plain top-k of the masked logits
    masked = x.copy()
    masked[:, E:] = -1e30
    w, i, p = router_topk_plain(torch.from_numpy(masked), k)
    assert torch.equal(r.idx, i) and torch.equal(r.w, w)
    assert torch.equal(r.probs, p)
    if mode == "tight" and T >= 64:
        assert (r.slot.numpy() == e_pad * C).any(), "expected drops"


@pytest.mark.parametrize("call", ["router_topk", "moe_layer"])
def test_kernel_refuses_inputs_that_need_grad(call):
    """The raw launch has no backward (logits that need a gradient go
    through ``router_dispatch``, whose ``RouterFunction`` carries it): it
    raises for them before it builds or binds the kernel (so the check
    runs here, on a CPU tensor handed to the card's path).  With
    gradients off the check passes and validation goes on."""
    T, E, k = 6, 40, 8
    kw = (dict(n_real=E, capacity=T) if call == "router_topk"
          else dict(n_real=E - 4, capacity=2))
    x = torch.from_numpy(_logits(T, E)).requires_grad_()
    built = kr._fn
    with pytest.raises(RuntimeError, match="no backward"):
        kr._router_dispatch_cuda(x, k, **kw)
    with torch.no_grad(), pytest.raises(ValueError, match="1 <= k"):
        kr._router_dispatch_cuda(x, E + 1, **kw)
    assert kr._fn is built                  # nothing was bound


def ties_within(got_idx, want_idx, want_probs, gap=1e-6):
    """Rows where the kernel's indices differ from the plain version's,
    each as (row, position, kernel's expert, plain's expert, their two
    plain probabilities); a swap is a tie when the two lie within
    ``gap``."""
    out = []
    for r, j in zip(*np.nonzero(got_idx != want_idx)):
        a, b = int(got_idx[r, j]), int(want_idx[r, j])
        out.append((int(r), int(j), a, b, float(want_probs[r, a]),
                    float(want_probs[r, b])))
    bad = [o for o in out if abs(o[4] - o[5]) > gap]
    return out, bad


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("TE,k", CASES + [((4, 40), 8), ((384, 40), 8),
                                          ((7, 512), 32), ((33, 1), 1)],
                         ids=lambda c: str(c))
def test_kernel_matches_plain_on_card(card, TE, k):
    T, E = TE
    x = torch.from_numpy(_logits(T, E, seed=3)).to(card)
    before = router_dispatch.launches
    w, idx, probs = router_topk(x, k)
    torch.cuda.synchronize()
    assert router_dispatch.launches == before + 1
    pw, pidx, pprobs = router_topk_plain(x, k)
    swaps, bad = ties_within(idx.cpu().numpy(), pidx.cpu().numpy(),
                             pprobs.cpu().numpy())
    assert not bad, f"index swaps beyond a tie: {bad}"
    if swaps:
        print("ties (row, pos, kernel, plain, p_kernel, p_plain):", swaps)
    torch.testing.assert_close(probs, pprobs, rtol=RTOL, atol=ATOL)
    if not swaps:
        torch.testing.assert_close(w, pw, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,n_real,mode", [
    (4, 40, 8, 40, "dropless"), (64, 40, 8, 40, "dropless"),
    (64, 40, 8, 40, "tight"), (64, 48, 8, 40, "cf1.25"),
    (300, 64, 6, 60, "tight"), (2600, 40, 8, 40, "dropless"),
    (1, 8, 2, 5, "dropless"), (77, 512, 32, 500, "tight")], ids=str)
def test_dispatch_kernel_matches_plain_on_card(card, T, E, k, n_real, mode):
    """Every output of the kernel against the plain version; slots, slot
    tokens and loads exactly, from the plain dispatch of the kernel's own
    choices (so a tie decided the other way cannot fail them)."""
    C = capacity_of(mode, T, n_real, k)
    x = torch.from_numpy(_logits(T, E, seed=T)).to(card)
    before = router_dispatch.launches
    r = router_dispatch(x, k, n_real=n_real, capacity=C)
    torch.cuda.synchronize()
    assert router_dispatch.launches == before + 1
    p = router_dispatch_plain(x, k, n_real=n_real, capacity=C)
    swaps, bad = ties_within(r.idx.cpu().numpy(), p.idx.cpu().numpy(),
                             p.probs.cpu().numpy())
    assert not bad, f"index swaps beyond a tie: {bad}"
    for name in ("probs", "prob_sum", "z_sum") + (() if swaps else ("w",)):
        torch.testing.assert_close(getattr(r, name), getattr(p, name),
                                   rtol=RTOL, atol=ATOL)
    for dispatch in ("sort", "cumsum"):
        slot, src, load = kr.dispatch_plain(r.idx, E, C, dispatch)
        assert torch.equal(r.slot, slot) and torch.equal(r.src, src)
        assert torch.equal(r.load, load)


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("T,cf", [(4, None), (64, None), (64, 0.5)],
                         ids=str)
def test_moe_layer_makes_no_host_sync_on_card(card, dispatch, T, cf):
    """A MoE layer call on the card (40 experts padded to 48, top-8)
    makes the host wait for nothing, and agrees with the same call on
    the CPU through the plain versions (f32, TF32 off)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(moe=MoEConfig(num_experts=40, top_k=8,
                                    dispatch=dispatch),
                      d_model=64, d_ff=32, vocab=64, compute_dtype="float32")
    p = moe.moe_params(cfg, torch.Generator().manual_seed(0), e_pad=48)
    x = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (1, T, 64)).astype(np.float32))
    kw = dict(dropless=True) if cf is None else dict(capacity_factor=cf)
    want, want_aux = moe.moe_apply(cfg, p, x, **kw)
    pc = {k: v.to(card) for k, v in p.items()}
    xc = x.to(card)
    moe.moe_apply(cfg, pc, xc, **kw)               # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_apply(cfg, pc, xc, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(y.cpu(), want, rtol=1e-4, atol=1e-4)
    for name in ("moe_lb", "moe_z"):
        torch.testing.assert_close(aux[name].cpu(), want_aux[name],
                                   rtol=1e-4, atol=1e-6)
