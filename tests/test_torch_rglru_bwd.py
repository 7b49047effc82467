"""The RG-LRU's backward in the port (repro_torch.kernels.rglru).

On the CPU: ``rglru_bwd_plain`` (the gradients of x, r_gate, i_gate,
log_lambda and h0 from those of h and h_final, the sequential reverse
recurrence) against ``jax.grad`` of the reference's sequential oracle
``ref.rglru_ref`` and of its associative scan ``ops._rglru_assoc``, and
against autograd through ``rglru_plain``, on the same numpy inputs and
upstream gradients, each gradient to 1e-5 of its largest entry (f32 on
both sides, summed in other orders; the measured gap is ~3e-7).  h0's
gradient is held against ``jax.grad`` with respect to h0 (a zero h0
where the case has none) and through ``RGLRUFunction``.  Then the plain
counterparts of the kernel's phases (the states the forward keeps, each
chunk's backward pair, the chunk's reverse run and dh0, the dΛ
reduction) composed against ``rglru_bwd_plain``.  Cases: S 1, 31, 32,
33, 100 and 128 (one chunk, a chunk less or more by one, a ragged last
chunk, whole chunks); W 8 and 64; h0 and dh_final on and off; gates
saturated near a = 1, where the clamp of 1 − a² binds on some steps and
a²/β is large on others.  ``rglru`` with inputs that need a gradient
goes through ``RGLRUFunction``.  On the card (``-m gpu``): the states the
forward kernels keep and the backward kernel against the plain versions,
f32, at recurrentgemma-9b's width, dh0 among the gradients; bf16 against
the plain version at the card's bf16 tolerance; two runs bitwise
equal.

The card's machine has no JAX, so JAX is imported by the ``ref`` fixture
and not at the top."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rglru as krg  # noqa: E402

TOL = 1e-5
NAMES = ("dx", "dr_gate", "di_gate", "dlog_lambda", "dh0")
# name, B, S, W, use_h0, use_dh_final, saturated
CASES = [
    ("s1", 2, 1, 8, False, False, False),
    ("s31-h0-dh", 2, 31, 8, True, True, False),
    ("s32-dh", 1, 32, 64, False, True, False),
    ("s33-h0", 2, 33, 64, True, False, False),
    ("s100-h0-dh", 2, 100, 8, True, True, False),
    ("s128", 1, 128, 64, False, False, False),
    ("s100-saturated-h0-dh", 2, 100, 64, True, True, True),
    ("s128-saturated", 2, 128, 8, False, False, True),
]


def _inputs(case, seed=0):
    """Numpy x, r_gate, i_gate normal, log_lambda over the model's
    init spread (-4.3 to -1.5), h0 0.2 z; then dh and dh_final.
    Saturated: Λ -4.3 and half the r_gate entries -40 (σr ~ 4e-18: a
    rounds to 1 and the clamp binds), -12 or -10 (1 − a² ~ 1e-6 to
    1e-5: a²/β in the hundreds)."""
    _, B, S, W, use_h0, use_dh, saturated = case
    rng = np.random.default_rng(seed)

    def z(*s):
        return rng.standard_normal(s).astype(np.float32)
    x, rg, ig = z(B, S, W), z(B, S, W), z(B, S, W)
    ll = np.linspace(-4.3, -1.5, W).astype(np.float32)
    if saturated:
        ll = np.full(W, -4.3, np.float32)
        low = rng.choice(np.float32([-40.0, -12.0, -10.0]), (B, S, W))
        rg = np.where(rng.random((B, S, W)) < 0.5, low, rg)
    h0 = z(B, W) * 0.2 if use_h0 else None
    dh = z(B, S, W)
    dhf = z(B, W) if use_dh else None
    return (x, rg, ig, ll, h0), dh, dhf


def _t(a, device="cpu"):
    return None if a is None else torch.from_numpy(np.array(a)).to(device)


def _close(got, want, tol=TOL, names=NAMES):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        scale = float(w.float().abs().max())
        err = float((g.float().cpu() - w.float().cpu()).abs().max())
        assert err <= tol * scale, (name, err, scale)


def _autograd(fn, ins, dh, dhf):
    """Gradients of sum(h dh) + sum(h_final dh_final) by autograd
    through ``fn`` (``rglru_plain`` or ``rglru``), in NAMES order."""
    x, rg, ig, ll, h0 = ins
    leaves = [t.clone().requires_grad_() for t in (x, rg, ig, ll)]
    h, hf = fn(*leaves, h0)
    loss = (h.float() * dh.float()).sum()
    if dhf is not None:
        loss = loss + (hf * dhf).sum()
    return list(torch.autograd.grad(loss, leaves)), h


def _chunked(ins, dh, dhf, chunk=krg.CHUNK):
    """The plain counterparts of the kernels' passes, composed: the
    forward's kept states, each chunk's backward pair, the reverse runs,
    the dΛ reduction."""
    x, rg, ig, ll, h0 = ins
    _, _, states = krg.rglru_keep_plain(x, rg, ig, ll, h0, chunk=chunk)
    A, e = krg.rglru_bwd_chunk_summary_plain(x, rg, ig, ll, dh, chunk=chunk)
    dx, dr, di, partials, dh0 = krg.rglru_bwd_chunk_apply_plain(
        x, rg, ig, ll, h0, dh, dhf, A, e, states, chunk=chunk)
    return [dx, dr, di, krg.rglru_bwd_reduce_plain(partials, ll), dh0]


@pytest.fixture(scope="module")
def ref():
    """jax.grad of the reference's RG-LRU (``ref.rglru_ref`` or
    ``ops._rglru_assoc``): numpy inputs -> numpy gradients."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops
    from repro.kernels.ref import rglru_ref
    fns = {"rglru_ref": rglru_ref, "_rglru_assoc": ops._rglru_assoc}

    def grads(name, x, rg, ig, ll, h0, dh, dhf, wrt_h0=False):
        """The gradients of x, r_gate, i_gate, log_lambda; with
        ``wrt_h0`` h0's alone (of a zero h0 where ``h0`` is None)."""
        h0 = np.zeros((x.shape[0], x.shape[2]), np.float32) \
            if h0 is None and wrt_h0 else h0

        def f(x, rg, ig, ll, h0):
            h, hf = fns[name](x, rg, ig, ll, h0)
            loss = (h * jnp.asarray(dh)).sum()
            return loss if dhf is None else loss + (hf * dhf).sum()
        args = [jnp.asarray(a) for a in (x, rg, ig, ll)] + [
            None if h0 is None else jnp.asarray(h0)]
        argnums = (4,) if wrt_h0 else (0, 1, 2, 3)
        return [np.array(g) for g in jax.grad(f, argnums=argnums)(*args)]
    return grads


@pytest.mark.parametrize("oracle", ["rglru_ref", "_rglru_assoc"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_jax(ref, case, oracle):
    arrays, dh, dhf = _inputs(case)
    want = ref(oracle, *arrays, dh, dhf)
    got = krg.rglru_bwd_plain(*[_t(a) for a in arrays], _t(dh), _t(dhf))
    _close(got, [_t(w) for w in want])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_autograd(case):
    arrays, dh, dhf = _inputs(case)
    ins, dh, dhf = [_t(a) for a in arrays], _t(dh), _t(dhf)
    want, _ = _autograd(krg.rglru_plain, ins, dh, dhf)
    _close(krg.rglru_bwd_plain(*ins, dh, dhf), want)


@pytest.mark.parametrize("chunk", [krg.CHUNK, 16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_chunk_passes_equal_the_plain_backward(case, chunk):
    """The kernels' chunked algebra at their chunk (and at 16, so that it
    does not lean on 32) against the sequential reverse recurrence."""
    arrays, dh, dhf = _inputs(case)
    ins, dh, dhf = [_t(a) for a in arrays], _t(dh), _t(dhf)
    _close(_chunked(ins, dh, dhf, chunk),
           krg.rglru_bwd_plain(*ins, dh, dhf))


def test_keep_plain_gives_the_states_entering_each_chunk():
    """``rglru_keep_plain`` (what the forward kernels keep for the
    backward): the state entering chunk c is the final state of the
    first 32·c steps, from h0; none for one chunk."""
    arrays, _, _ = _inputs(CASES[4])                  # S 100, h0
    x, rg, ig, ll, h0 = [_t(a) for a in arrays]
    h, hf, states = krg.rglru_keep_plain(x, rg, ig, ll, h0)
    want_h, want_hf = krg.rglru_plain(x, rg, ig, ll, h0)
    assert torch.equal(h, want_h) and torch.equal(hf, want_hf)
    L = krg.CHUNK
    assert states.shape == (2, 4, 8) and states.dtype == torch.float32
    assert torch.equal(states[:, 0], h0)
    for c in range(1, 4):
        _, hc = krg.rglru_plain(x[:, :c * L], rg[:, :c * L], ig[:, :c * L],
                                ll, h0)
        torch.testing.assert_close(states[:, c], hc)
    assert krg.rglru_keep_plain(x[:, :L], rg[:, :L], ig[:, :L], ll,
                                h0)[2] is None


@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[6]],
                         ids=lambda c: c[0])
def test_rglru_function_carries_the_gradient(case):
    """``rglru`` with inputs that need a gradient: RGLRUFunction, the
    plain forward and ``rglru_bwd_plain``, no kernel."""
    arrays, dh, dhf = _inputs(case)
    ins, dh, dhf = [_t(a) for a in arrays], _t(dh), _t(dhf)
    before = (krg.rglru.launches, krg.rglru_bwd.launches)
    got, h = _autograd(krg.rglru, ins, dh, dhf)
    assert type(h.grad_fn).__name__ == "RGLRUFunctionBackward"
    assert (krg.rglru.launches, krg.rglru_bwd.launches) == before
    want, _ = _autograd(krg.rglru_plain, ins, dh, dhf)
    _close(got, want)


def test_unused_outputs_take_zero_gradient():
    """A loss of h_final alone (dh None) or of h alone (dh_final None)."""
    arrays, _, _ = _inputs(CASES[4])
    ins = [_t(a) for a in arrays]
    for pick in (1, 0):
        leaves = [t.clone().requires_grad_() for t in ins[:4]]
        got = torch.autograd.grad(
            krg.rglru(*leaves, ins[4])[pick].sum(), leaves)
        leaves = [t.clone().requires_grad_() for t in ins[:4]]
        want = torch.autograd.grad(
            krg.rglru_plain(*leaves, ins[4])[pick].sum(), leaves)
        _close(got, want)


@pytest.mark.parametrize("oracle", ["rglru_ref", "_rglru_assoc"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_dh0_matches_jax(ref, case, oracle):
    """h0's gradient, a₀·g₀, against ``jax.grad`` with respect to h0 (of
    a zero h0 where the case has none), to 1e-5 of its largest entry."""
    arrays, dh, dhf = _inputs(case)
    (want,) = ref(oracle, *arrays, dh, dhf, wrt_h0=True)
    got = krg.rglru_bwd_plain(*[_t(a) for a in arrays], _t(dh), _t(dhf))[4]
    _close([got], [_t(want)], names=("dh0",))


@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[6]],
                         ids=lambda c: c[0])
def test_rglru_function_gives_h0_its_gradient(case):
    """``rglru`` with an h0 that needs a gradient goes through
    RGLRUFunction and gives every input, h0 among them, autograd's
    gradient through rglru_plain; so does an h0 that alone needs one."""
    arrays, dh, dhf = _inputs(case)
    ins, dh, dhf = [_t(a) for a in arrays], _t(dh), _t(dhf)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        h, hf = fn(*leaves)
        loss = (h * dh).sum() + (hf * dhf).sum()
        return list(torch.autograd.grad(loss, leaves)), h
    got, h = grads(krg.rglru)
    assert type(h.grad_fn).__name__ == "RGLRUFunctionBackward"
    want, _ = grads(krg.rglru_plain)
    _close(got, want)
    h0 = ins[4].clone().requires_grad_()
    h, hf = krg.rglru(*ins[:4], h0)
    assert type(h.grad_fn).__name__ == "RGLRUFunctionBackward"
    (g,) = torch.autograd.grad((h * dh).sum() + (hf * dhf).sum(), [h0])
    _close([g], [want[4]], names=("dh0",))


def test_backward_launch_checks_before_building():
    """The backward's launch validates its inputs before it builds or
    binds anything (so the check runs here, on CPU tensors): dh's shape,
    the entering states of a sequence of several chunks, f16 (the kernel
    takes f32 and bf16)."""
    arrays, dh, _ = _inputs(CASES[4])
    ins, dh = [_t(a) for a in arrays], _t(dh)
    built = krg._bwd_fn
    with pytest.raises(ValueError, match="dh"):
        krg._rglru_bwd_cuda(*ins, dh[:, :-1], None, None)
    with pytest.raises(ValueError, match="entering states"):
        krg._rglru_bwd_cuda(*ins, dh, None, None)
    half = [t.half() for t in ins[:3]] + ins[3:]
    with pytest.raises(ValueError, match="dtypes"):
        krg._rglru_bwd_cuda(*half, dh.half(), None, None)
    assert krg._bwd_fn is built


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
# recurrentgemma-9b's width: training's 8 x 128, 2 x 1024 (dh_final), a
# ragged S 100 (h0, dh_final), S 1 (one chunk), saturated
CARD_CASES = CASES + [
    ("rg9b-b8-s128", 8, 128, 4096, False, False, False),
    ("rg9b-b2-s1024-dh", 2, 1024, 4096, False, True, False),
    ("rg9b-b1-s100-h0-dh", 1, 100, 4096, True, True, False),
    ("rg9b-b4-s1", 4, 1, 4096, False, False, False),
    ("rg9b-b2-s128-saturated-dh", 2, 128, 4096, False, True, True),
]
# the kernels' expf / sqrtf against torch's, in another order; the
# gradients against their largest entries.  bf16: the f32 arithmetic's
# outputs rounded to bf16 (2^-8 relative), against torch's f32 plain
# version rounded the same way: 2e-2 and one unit in the last place of
# the largest entry, as the SSD's backward is held
GPU_TOL = 1e-4
GPU_TOL_BF16 = 2e-2 + 2.0 ** -7


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[0])
def test_bwd_kernels_match_plain_on_card(case):
    """RGLRUFunction on the card (the forward kernels keep their entering
    states, the backward kernel reads them) against autograd through
    rglru_plain and against rglru_bwd_plain on the same inputs, dh0 too;
    two runs bitwise equal; one backward launch a call."""
    _card()
    arrays, dh, dhf = _inputs(case)
    ins = [_t(a, "cuda") for a in arrays]
    dh, dhf = _t(dh, "cuda"), _t(dhf, "cuda")
    _, _, states = krg._rglru_cuda(*ins, keep=True)
    _, _, want_states = krg.rglru_keep_plain(*ins)
    if want_states is None:
        assert states is None
    else:
        _close([states], [want_states], tol=2e-4, names=("states",))
    before = krg.rglru_bwd.launches
    got, _ = _autograd(krg.rglru, ins, dh, dhf)
    again, _ = _autograd(krg.rglru, ins, dh, dhf)
    torch.cuda.synchronize()
    assert krg.rglru_bwd.launches == before + 2
    want, _ = _autograd(krg.rglru_plain, ins, dh, dhf)
    _close(got, want, tol=GPU_TOL)
    _close(got, krg.rglru_bwd_plain(*ins, dh, dhf), tol=GPU_TOL)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    raw = krg._rglru_bwd_cuda(*ins, dh, dhf, states)
    _close(raw, krg.rglru_bwd_plain(*ins, dh, dhf), tol=GPU_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [CASES[1], CASES[6]] + CARD_CASES[-5:-3],
                         ids=lambda c: c[0])
def test_h0_gradient_on_card(case):
    """An h0 that needs a gradient, through RGLRUFunction on the card,
    against autograd through rglru_plain."""
    _card()
    arrays, dh, dhf = _inputs(case)
    if arrays[4] is None:
        arrays = arrays[:4] + (np.zeros((case[1], case[3]), np.float32),)
    ins = [_t(a, "cuda") for a in arrays]
    dh, dhf = _t(dh, "cuda"), _t(dhf, "cuda")

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        h, hf = fn(*leaves)
        loss = (h * dh).sum()
        if dhf is not None:
            loss = loss + (hf * dhf).sum()
        return list(torch.autograd.grad(loss, leaves))
    got = grads(krg.rglru)
    torch.cuda.synchronize()
    _close(got, grads(krg.rglru_plain), tol=GPU_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [CASES[2], CASES[4], CASES[7]]
                         + CARD_CASES[-5:], ids=lambda c: c[0])
def test_bf16_gradient_matches_plain_on_card(case):
    """A bf16 RG-LRU that needs a gradient trains on the card: the
    forward keeps f32 states, the backward kernel takes bf16 x, gates and
    dh (two channels a thread at even W) and writes bf16 gradients, in
    f32 arithmetic; against rglru_bwd_plain on the same bf16 inputs and
    the same kept states' forward, GPU_TOL_BF16; two runs bitwise."""
    _card()
    arrays, dh, dhf = _inputs(case)
    ins = [_t(a, "cuda") for a in arrays]
    ins[:3] = [t.bfloat16() for t in ins[:3]]
    dh, dhf = _t(dh, "cuda").bfloat16(), _t(dhf, "cuda")
    _, _, states = krg._rglru_cuda(*ins, keep=True)
    got = krg._rglru_bwd_cuda(*ins, dh, dhf, states)
    again = krg._rglru_bwd_cuda(*ins, dh, dhf, states)
    torch.cuda.synchronize()
    want = krg.rglru_bwd_plain(*ins, dh, dhf)
    _close(got, want, tol=GPU_TOL_BF16)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # and through autograd, as a bf16 model's layer would call it
    leaves = [t.clone().requires_grad_() for t in ins[:4]]
    h, hf = krg.rglru(*leaves, ins[4])
    assert h.dtype == torch.bfloat16
    loss = (h.float() * dh.float()).sum()
    if dhf is not None:
        loss = loss + (hf * dhf).sum()
    grads = torch.autograd.grad(loss, leaves)
    _close(grads, got[:4], tol=GPU_TOL_BF16)
