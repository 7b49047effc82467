"""The SSD's backward in the port (repro_torch.kernels.ssd).

On the CPU: ``ssd_bwd_plain`` (the gradients of x, dt, A, B, C and D
from those of y and h_final, in the kernels' chunked algebra at their
64-token chunk) against autograd through ``ssd_plain`` and against
``jax.vjp`` of the reference's sequential oracle ``ref.ssd_ref``, on the
same numpy inputs and upstream gradients, each gradient to 1e-4 of its
largest entry (f32 on both sides; the chunked and sequential forms sum
in other orders).  Cases: S 1, 63, 64, 100 (a ragged last chunk: dt = 0
padding must give the padded rows nothing) and 256; G 1 and 2; D on and
off; h0 and dh_final on and off.  h0's gradient (``with_dh0``: the
walk's one more step, through chunk 0) against ``jax.vjp`` with respect
to h0 (a zero h0 where the case has none), through ``SSDFunction`` and
from the walk's plain counterpart.  ``ssd`` with inputs that need a
gradient goes through ``SSDFunction``, and autograd through ``ssd_plain``
gives no NaN (the masked exponents are masked before ``exp``);
``ssd_keep_plain`` gives the states entering each chunk.  On the card
(``-m gpu``): the states the forward kernels keep, and the backward
kernels, against the plain versions, f32 and bf16, dh0, and the
launches.

The card's machine has no JAX, so JAX is imported by the ``ref`` fixture
and not at the top."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd as kssd  # noqa: E402

TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
# name, B, S, H, P, G, N, use_D, use_h0, use_dh
CASES = [
    ("s1", 2, 1, 4, 8, 1, 16, True, False, False),
    ("s63-g2", 2, 63, 4, 8, 2, 16, True, True, True),
    ("s64", 1, 64, 4, 8, 1, 16, False, False, True),
    ("s100-g2", 2, 100, 4, 16, 2, 8, True, False, True),
    ("s100-noD", 1, 100, 2, 8, 1, 16, False, True, False),
    ("s256-g1", 1, 256, 4, 8, 1, 16, True, True, True),
]


def _inputs(case, seed=0):
    """Numpy inputs as tests/test_kernels.py draws them (dt softplus'ed,
    A = -exp(0.5 z), B and C 0.3 z, h0 0.1 z), then dy and dh_final."""
    _, B, S, H, P, G, N, use_D, use_h0, use_dh = case
    rng = np.random.default_rng(seed)

    def z(*s):
        return rng.standard_normal(s).astype(np.float32)
    x, dt = z(B, S, H, P), np.logaddexp(z(B, S, H), 0.0).astype(np.float32)
    A = -np.exp(z(H) * 0.5).astype(np.float32)
    Bm, Cm = z(B, S, G, N) * 0.3, z(B, S, G, N) * 0.3
    D = z(H) if use_D else None
    h0 = z(B, H, P, N) * 0.1 if use_h0 else None
    dy = z(B, S, H, P)
    dh = z(B, H, P, N) if use_dh else None
    return (x, dt, A, Bm, Cm, D, h0), dy, dh


def _t(a, device="cpu", dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _autograd(fn, ins, dy, dh, **kw):
    """Gradients of sum(y dy) + sum(h_final dh) by autograd through
    ``fn`` (``ssd_plain`` or ``ssd``), in NAMES order (dD None without
    D)."""
    x, dt, A, B, C, D, h0 = ins
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    Dg = None if D is None else D.clone().requires_grad_()
    y, hf = fn(*leaves, Dg, h0, **kw)
    loss = (y.float() * dy.float()).sum()
    if dh is not None:
        loss = loss + (hf * dh).sum()
    wrt = leaves + ([Dg] if Dg is not None else [])
    grads = list(torch.autograd.grad(loss, wrt))
    return grads + ([None] if Dg is None else []), y


def _close(got, want, tol=TOL, names=NAMES):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * scale or err <= 1e-7, (name, err, scale)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_autograd(case):
    arrays, dy, dh = _inputs(case)
    ins, dy, dh = [_t(a) for a in arrays], _t(dy), _t(dh)
    want, _ = _autograd(kssd.ssd_plain, ins, dy, dh)
    assert all(w is None or bool(torch.isfinite(w).all()) for w in want)
    got = kssd.ssd_bwd_plain(*ins, dy, dh)
    _close(got, want)


@pytest.fixture(scope="module")
def ref():
    """jax.vjp of ``ref.ssd_ref``: numpy inputs -> numpy gradients."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ref import ssd_ref

    def grads(x, dt, A, B, C, D, h0, dy, dh, wrt_h0=False):
        """The gradients of x, dt, A, B, C, D; with ``wrt_h0`` h0's
        alone (of a zero h0 where ``h0`` is None)."""
        if wrt_h0:
            h0 = np.zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[3]),
                          np.float32) if h0 is None else h0
            fixed = [jnp.asarray(a) for a in (x, dt, A, B, C)] + [
                None if D is None else jnp.asarray(D)]

            def f(h0):
                return ssd_ref(*fixed, h0)
            args = [jnp.asarray(h0)]
        else:
            def f(x, dt, A, B, C, D):
                return ssd_ref(x, dt, A, B, C, D,
                               None if h0 is None else jnp.asarray(h0))
            args = [jnp.asarray(a) for a in (x, dt, A, B, C)] + [
                None if D is None else jnp.asarray(D)]
        (y, hf), vjp = jax.vjp(f, *args)
        cot = (jnp.asarray(dy), jnp.zeros_like(hf) if dh is None
               else jnp.asarray(dh))
        return [None if g is None else np.array(g) for g in vjp(cot)]
    return grads


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_jax(ref, case):
    arrays, dy, dh = _inputs(case)
    want = ref(*arrays, dy, dh)
    got = kssd.ssd_bwd_plain(*[_t(a) for a in arrays], _t(dy), _t(dh))
    _close(got, [_t(w) for w in want])


@pytest.mark.parametrize("case", CASES[1:4], ids=lambda c: c[0])
def test_ssd_function_carries_the_gradient(case):
    """``ssd`` with inputs that need a gradient: SSDFunction, the plain
    forward and ``ssd_bwd_plain`` at the model's chunk, no kernel."""
    arrays, dy, dh = _inputs(case)
    ins, dy, dh = [_t(a) for a in arrays], _t(dy), _t(dh)
    before = (kssd.ssd.launches, kssd.ssd_bwd.launches)
    got, y = _autograd(kssd.ssd, ins, dy, dh, chunk=32)
    assert type(y.grad_fn).__name__ == "SSDFunctionBackward"
    assert (kssd.ssd.launches, kssd.ssd_bwd.launches) == before
    want, _ = _autograd(kssd.ssd_plain, ins, dy, dh)
    _close(got, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_dh0_matches_jax(ref, case):
    """h0's gradient, decay_0·G_0 + R_0, against ``jax.vjp`` of
    ``ref.ssd_ref`` with respect to h0 (of a zero h0 where the case has
    none), to 1e-4 of its largest entry; the other gradients unchanged by
    asking for it."""
    arrays, dy, dh = _inputs(case)
    (want,) = ref(*arrays, dy, dh, wrt_h0=True)
    ins = [_t(a) for a in arrays]
    got = kssd.ssd_bwd_plain(*ins, _t(dy), _t(dh), with_dh0=True)
    assert len(got) == 7
    _close([got[6]], [_t(want)], names=("dh0",))
    for g, w in zip(got, kssd.ssd_bwd_plain(*ins, _t(dy), _t(dh))):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[5]],
                         ids=lambda c: c[0])
def test_ssd_function_gives_h0_its_gradient(case):
    """``ssd`` with an h0 that needs a gradient goes through SSDFunction
    (plain on the CPU) and gives h0 autograd's gradient through
    ``ssd_plain``; the walk's plain counterpart, one step further, gives
    the same dh0."""
    arrays, dy, dh = _inputs(case)
    ins, dy, dh = [_t(a) for a in arrays], _t(dy), _t(dh)

    def grad_h0(fn, **kw):
        h0 = ins[6].clone().requires_grad_()
        x = ins[0].clone().requires_grad_()
        y, hf = fn(x, *ins[1:6], h0, **kw)
        loss = (y * dy).sum() + (0 if dh is None else (hf * dh).sum())
        return torch.autograd.grad(loss, [x, h0]), y
    (gx, got), y = grad_h0(kssd.ssd, chunk=32)
    assert type(y.grad_fn).__name__ == "SSDFunctionBackward"
    (wx, want), _ = grad_h0(kssd.ssd_plain)
    _close([gx, got], [wx, want], names=("dx", "dh0"))
    x, dt, A, B, C, D, h0 = ins
    _, _, _, decay = kssd.ssd_keep_plain(x, dt, A, B, C, D, h0)
    _, walked = kssd.ssd_bwd_state_plain(dy, dt, A, C, decay, dh,
                                         with_dh0=True)
    _close([walked], [want], names=("dh0",))


def test_padded_rows_take_no_gradient():
    """The plain backward at S 100 equals it on the first 100 rows of a
    sequence padded to 128 with dt = 0 and x = B = C = dy = 0: an
    identity step adds nothing."""
    arrays, dy, dh = _inputs(CASES[3])
    ins, dy, dh = [_t(a) for a in arrays], _t(dy), _t(dh)
    got = kssd.ssd_bwd_plain(*ins, dy, dh)

    def pad(t):
        return torch.nn.functional.pad(
            t, (0, 0) * (t.ndim - 2) + (0, 28))
    x, dt, A, B, C, D, h0 = ins
    padded = kssd.ssd_bwd_plain(pad(x), pad(dt), A, pad(B), pad(C), D, h0,
                                pad(dy), dh)
    for name, g, p in zip(NAMES, got, padded):
        if g.ndim >= 2 and g.shape[1] == 100:
            p = p[:, :100]
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6, msg=name)


def test_keep_plain_gives_the_states_entering_each_chunk():
    """``ssd_keep_plain`` (what the forward kernels keep for the
    backward): the state entering chunk c is the final state of the
    first 64·c tokens, from h0; the decay is exp of the chunk's Σ dt·A."""
    arrays, _, _ = _inputs(CASES[5])            # S 256, h0
    x, dt, A, B, C, D, h0 = [_t(a) for a in arrays]
    y, hf, entering, decay = kssd.ssd_keep_plain(x, dt, A, B, C, D, h0)
    want_y, want_hf = kssd.ssd_plain(x, dt, A, B, C, D, h0)
    torch.testing.assert_close(y, want_y)
    torch.testing.assert_close(hf, want_hf)
    Q = kssd.CHUNK
    assert entering.shape[1] == decay.shape[1] == 256 // Q
    torch.testing.assert_close(entering[:, 0], h0)
    for c in range(1, 256 // Q):
        _, h = kssd.ssd_plain(x[:, :c * Q], dt[:, :c * Q], A, B[:, :c * Q],
                              C[:, :c * Q], D, h0)
        torch.testing.assert_close(entering[:, c], h, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        decay, torch.exp((dt * A).reshape(1, -1, Q, 4).sum(2)),
        rtol=1e-5, atol=1e-7)
    assert kssd.ssd_keep_plain(x[:, :Q], dt[:, :Q], A, B[:, :Q], C[:, :Q],
                               D, h0)[2:] == (None, None)


def test_backward_launch_checks_before_building():
    """The backward's launch validates its inputs before it builds or
    binds anything (so the check runs here, on CPU tensors)."""
    arrays, dy, dh = _inputs(CASES[3])
    ins, dy = [_t(a) for a in arrays], _t(dy)
    built = kssd._bwd_fn
    with pytest.raises(ValueError, match="dy"):
        kssd._ssd_bwd_cuda(*ins, dy[:, :-1], None, None, None)
    with pytest.raises(ValueError, match="entering states"):
        kssd._ssd_bwd_cuda(*ins, dy, None, None, None)
    assert kssd._bwd_fn is built


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
# mamba2-1.3b's heads at training's 8 x 128, one chunk, a ragged tail
CARD_CASES = CASES + [
    ("mamba2-b8-s128", 8, 128, 64, 64, 1, 128, True, False, False),
    ("mamba2-b1-s100", 1, 100, 64, 64, 1, 128, True, False, True),
    ("mamba2-b2-s40-h0", 2, 40, 64, 64, 1, 128, True, True, True),
    ("g8-b1-s200", 1, 200, 16, 64, 8, 128, True, True, True),
]
# bf16: 2e-2 and one unit in the last place (2^-7) of the largest entry
GPU_TOL = {"float32": 1e-4, "bfloat16": 2e-2 + 2.0 ** -7}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[4], CASES[5]]
                         + CARD_CASES[-4:], ids=lambda c: c[0])
def test_dh0_matches_plain_on_card(case, dt):
    """The walk's one more step on the card (one chunk: the walk alone):
    dh0 and the other gradients against ``ssd_bwd_plain(with_dh0=True)``
    on the forward kernels' kept states; through SSDFunction with an h0
    that needs a gradient; two runs bitwise equal."""
    _card()
    dtype = getattr(torch, dt)
    arrays, dy, dh = _inputs(case)
    ins = [_t(a, "cuda", dtype if i in (0, 3, 4) else None)
           for i, a in enumerate(arrays)]
    dy, dh = _t(dy, "cuda", dtype), _t(dh, "cuda")
    _, _, states, decay = kssd._ssd_cuda(*ins, keep=True)
    got = kssd._ssd_bwd_cuda(*ins, dy, dh, states, decay, with_dh0=True)
    again = kssd._ssd_bwd_cuda(*ins, dy, dh, states, decay, with_dh0=True)
    torch.cuda.synchronize()
    want = kssd.ssd_bwd_plain(*ins, dy, dh, with_dh0=True)
    _close(got, want, tol=GPU_TOL[dt], names=NAMES + ("dh0",))
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)
    if ins[6] is not None:
        h0 = ins[6].clone().requires_grad_()
        y, hf = kssd.ssd(*ins[:6], h0)
        loss = (y.float() * dy.float()).sum()
        if dh is not None:
            loss = loss + (hf * dh).sum()
        (g,) = torch.autograd.grad(loss, [h0])
        _close([g], [want[6]], tol=GPU_TOL[dt], names=("dh0",))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[0])
def test_bwd_kernels_match_plain_on_card(case, dt):
    """SSDFunction on the card (forward kernels keep their states, the
    backward kernels read them) against autograd through ssd_plain on the
    same inputs; two runs bitwise equal."""
    _card()
    dtype = getattr(torch, dt)
    arrays, dy, dh = _inputs(case)
    ins = [_t(a, "cuda", dtype if i in (0, 3, 4) else None)
           for i, a in enumerate(arrays)]
    dy, dh = _t(dy, "cuda", dtype), _t(dh, "cuda")
    _, _, states, decay = kssd._ssd_cuda(*ins, keep=True)
    _, _, want_states, want_decay = kssd.ssd_keep_plain(*ins)
    if want_states is not None:             # what the backward reads
        _close([states, decay], [want_states, want_decay], tol=2e-4,
               names=("states", "decay"))
    before = kssd.ssd_bwd.launches
    got, _ = _autograd(kssd.ssd, ins, dy, dh)
    again, _ = _autograd(kssd.ssd, ins, dy, dh)
    torch.cuda.synchronize()
    assert kssd.ssd_bwd.launches == before + 2
    want, _ = _autograd(kssd.ssd_plain, ins, dy, dh)
    _close(got, want, tol=GPU_TOL[dt])
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)
