"""The SSD backward's tensor-core design (``csrc/ssd_bwd.cu``), on the CPU.

On the card the backward is three launches: a reverse walk a (row, head,
half of N) that forms each chunk's R_c = Σ exp(cum_i)·dy_i ⊗ C_i and the
gradients of the states leaving the chunks, beside each chunk's C·Bᵀ once
a group; the chunk pass, whose dx blocks write dx, ddt and the dA, dD
partials and whose dB/dC blocks walk a slice of hs heads of a group in
order; and the ordered sums.  Here their plain counterparts
(``ssd_bwd_state_plain``, ``ssd_chunk_cb_plain``, ``ssd_bwd_dx_plain``,
``ssd_bwd_dbdc_plain``, ``ssd_bwd_reduce_plain``), composed at every
slice size hs the kernel can take, must equal ``ssd_bwd_plain`` at 1e-5
of each gradient's largest entry (f32; the same algebra, other
associations), and ``jax.vjp`` of the reference's sequential
``ref.ssd_ref`` at 1e-4, as ``tests/test_torch_ssd_bwd.py`` holds
``ssd_bwd_plain``; the walk's leaving gradients are each chunk's
``jax.vjp`` with respect to the state entering the rest of the sequence.
``ssd_bwd_plan``'s slice size divides the group and keeps two dB/dC blocks
an SM.  Last, the accuracy of the products on the tensor cores, by
emulation at mamba2-1.3b's heads: every product of the passes in 3xTF32
(what the kernels run) keeps each gradient within the card's GRAD_TOL
(1e-4 of its largest entry) of ``ssd_bwd_plain``, including dA and ddt
through the straddling sums; plain TF32 does not.  On the card (``-m
gpu``): the kernels at every slice size, ragged chunks, bitwise repeats,
and the launch plan's two chunk blocks an SM."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd as kssd  # noqa: E402
from test_torch_ssd_bwd import (CASES, GPU_TOL, NAMES, _autograd,  # noqa: E402
                                _close, _inputs, _t)

PASS_TOL = 1e-5      # the same algebra in other associations, f32
REF_TOL = 1e-4       # tests/test_torch_ssd_bwd.py's tolerance to ref.ssd_ref
GRAD_TOL = 1e-4      # chip_smoke.py's f32 gradient tolerance on the card


def _divisors(n, most=16):
    return [d for d in range(1, min(n, most) + 1) if n % d == 0]


def _passes(x, dt, A, B, C, D, h0, dy, dh, hs):
    """The backward as the kernels split it, in plain torch."""
    states, decay = kssd.ssd_chunk_states_plain(x, dt, A, B)
    entering, _ = kssd.ssd_state_passing_plain(states, decay, h0)
    leaving = kssd.ssd_bwd_state_plain(dy, dt, A, C, decay, dh)
    cb = kssd.ssd_chunk_cb_plain(B, C)
    dx, ddt, dA_part, dD_part = kssd.ssd_bwd_dx_plain(
        x, dt, A, B, C, D, dy, cb, leaving, entering)
    dBp, dCp = kssd.ssd_bwd_dbdc_plain(x, dt, A, B, C, dy, leaving,
                                       entering, hs)
    H = x.shape[2]
    assert dBp.shape == dCp.shape == (*B.shape[:2], H // hs, B.shape[3])
    dB, dC, dA, dD = kssd.ssd_bwd_reduce_plain(
        dBp, dCp, dA_part, dD_part, B.shape[2], B.dtype, D is not None)
    return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC,
            None if D is None else dD.to(D.dtype))


# N and P that are no multiple of 4 (the kernels read such rows one
# element at a time)
ODD_CASES = [("n90-p18-g2", 1, 200, 4, 18, 2, 90, True, True, True)]
HS_CASES = [(case, hs) for case in CASES + ODD_CASES
            for hs in _divisors(case[3] // case[5])]


@pytest.mark.parametrize("case,hs", HS_CASES,
                         ids=lambda v: v[0] if isinstance(v, tuple)
                         else f"hs{v}")
def test_passes_equal_plain_backward(case, hs):
    arrays, dy, dh = _inputs(case)
    ins, dy, dh = [_t(a) for a in arrays], _t(dy), _t(dh)
    want = kssd.ssd_bwd_plain(*ins, dy, dh)
    got = _passes(*ins, dy, dh, hs)
    _close(got, want, tol=PASS_TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_walk_visits_chunks_from_the_last(case):
    """The leaving gradient of the last chunk is dh_final (or zero), and
    each earlier one is decay·G + R of the chunk after it."""
    arrays, dy, dh = _inputs(case)
    x, dt, A, B, C, D, h0 = [_t(a) for a in arrays]
    dy, dh = _t(dy), _t(dh)
    _, decay = kssd.ssd_chunk_states_plain(x, dt, A, B)
    leaving = kssd.ssd_bwd_state_plain(dy, dt, A, C, decay, dh)
    nc = -(-x.shape[1] // kssd.CHUNK)
    assert leaving.shape == (x.shape[0], nc, x.shape[2], x.shape[3],
                             B.shape[3])
    torch.testing.assert_close(
        leaving[:, -1], torch.zeros_like(leaving[:, -1]) if dh is None
        else dh)


@pytest.fixture(scope="module")
def ref():
    """jax.vjp of ``ref.ssd_ref``: numpy inputs -> numpy gradients of
    (x, dt, A, B, C, D) and, with ``wrt_h0``, of h0."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ref import ssd_ref

    def grads(x, dt, A, B, C, D, h0, dy, dh, wrt_h0=False):
        def f(x, dt, A, B, C, D, h0):
            return ssd_ref(x, dt, A, B, C, D, h0)
        args = [jnp.asarray(a) for a in (x, dt, A, B, C)] + [
            None if D is None else jnp.asarray(D),
            None if h0 is None else jnp.asarray(h0)]
        (y, hf), vjp = jax.vjp(f, *args)
        cot = (jnp.asarray(dy), jnp.zeros_like(hf) if dh is None
               else jnp.asarray(dh))
        out = [None if g is None else np.array(g) for g in vjp(cot)]
        return out if wrt_h0 else out[:6]
    return grads


@pytest.mark.parametrize("case,hs", [(c, max(_divisors(c[3] // c[5])))
                                     for c in CASES + ODD_CASES],
                         ids=lambda v: v[0] if isinstance(v, tuple)
                         else f"hs{v}")
def test_passes_match_jax(ref, case, hs):
    arrays, dy, dh = _inputs(case)
    want = ref(*arrays, dy, dh)
    got = _passes(*[_t(a) for a in arrays], _t(dy), _t(dh), hs)
    _close(got, [_t(w) for w in want], tol=REF_TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c[2] > kssd.CHUNK],
                         ids=lambda c: c[0])
def test_walk_matches_jax(ref, case):
    """G_c, the gradient of the state leaving chunk c, is the gradient
    of the loss with respect to the state entering the tokens after it:
    ``jax.vjp`` of ``ref.ssd_ref`` over those tokens from a zero state
    (the loss is linear in that state)."""
    arrays, dy, dh = _inputs(case)
    x, dt, A, B, C, D, h0 = arrays
    t = [_t(a) for a in arrays]
    _, decay = kssd.ssd_chunk_states_plain(t[0], t[1], t[2], t[3])
    leaving = kssd.ssd_bwd_state_plain(_t(dy), t[1], t[2], t[4], decay,
                                       _t(dh))
    Q, S = kssd.CHUNK, x.shape[1]
    zero = np.zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[3]),
                    np.float32)
    for c in range(-(-S // Q) - 1):
        lo = (c + 1) * Q
        want = ref(x[:, lo:], dt[:, lo:], A, B[:, lo:], C[:, lo:], D, zero,
                   dy[:, lo:], dh, wrt_h0=True)[6]
        _close([leaving[:, c]], [_t(want)], tol=REF_TOL, names=("G",))


def test_plan_takes_a_slice_of_the_group():
    """hs divides the group, is at most 16, and keeps a dB/dC block an SM
    of 132 where that can be had: at training's 8 × 128 8 heads (256
    blocks), at 2 × 1024 16, one ragged chunk of one row 1."""
    for B, S, H, G in ((8, 128, 64, 1), (2, 1024, 64, 1), (1, 100, 64, 1),
                       (2, 256, 64, 8), (1, 1, 4, 2), (3, 700, 24, 3)):
        hs = kssd.ssd_bwd_plan(B, S, H, G, 128)
        assert 1 <= hs <= 16 and (H // G) % hs == 0
        blocks = (H // hs) * 2 * -(-S // kssd.CHUNK) * B
        assert hs == 1 or blocks >= 132
    assert kssd.ssd_bwd_plan(8, 128, 64, 1, 128) == 8
    assert kssd.ssd_bwd_plan(2, 1024, 64, 1, 128) == 16
    assert kssd.ssd_bwd_plan(1, 100, 64, 1, 128) == 1
    assert kssd.ssd_bwd_plan(2, 256, 64, 8, 128) == 4


def test_launch_refuses_a_slice_that_does_not_divide_the_group():
    arrays, dy, _ = _inputs(CASES[1])                   # H 4, G 2
    ins = [_t(a) for a in arrays]
    built = kssd._bwd_fn
    with pytest.raises(ValueError, match="hs"):
        kssd._ssd_bwd_cuda(*ins, _t(dy), None, None, None, hs=3)
    assert kssd._bwd_fn is built


# --- the tensor-core question, by emulation --------------------------------
def _tf32(t):
    """t with the 13 low mantissa bits zeroed, as ``split_tf32`` cuts."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(einsum):
    def mm(eq, a, b):
        return einsum(eq, _tf32(a.float()), _tf32(b.float()))
    return mm


def _mm_3xtf32(einsum):
    """a·b as a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, as ``warp_mma3``."""
    def mm(eq, a, b):
        a, b = a.float(), b.float()
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        return (einsum(eq, a_hi, b_lo) + einsum(eq, a_lo, b_hi)
                + einsum(eq, a_hi, b_hi))
    return mm


def _scaled_errors(got, want):
    return {n: float((g.float() - w.float()).abs().max())
            / float(w.float().abs().max())
            for n, g, w in zip(NAMES, got, want) if w is not None}


# mamba2-1.3b's heads (H 64, P 64, N 128), G 1 and 8: one token, a
# ragged chunk, four chunks; D, h0 and dh_final on
EMU_CASES = [
    ("s1-g1", 1, 1, 64, 64, 1, 128, True, True, True),
    ("s100-g1", 1, 100, 64, 64, 1, 128, True, True, True),
    ("s256-g1", 1, 256, 64, 64, 1, 128, True, True, True),
    ("s256-g8", 1, 256, 64, 64, 8, 128, True, True, True),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: c[0])
def test_3xtf32_products_hold_grad_tol(case, monkeypatch):
    """Every product of the passes (C·Bᵀ, R_c, dy·xᵀ, M1ᵀ·dy, B·Gᵀ,
    C·h_inᵀ, M2ᵀ·C, (w∘x)·G, M2·B, (e∘dy)·h_in) in 3xTF32 keeps every
    gradient within GRAD_TOL of its largest entry against
    ``ssd_bwd_plain`` (at most 1.7e-6 at these cases); in plain TF32
    (~3 digits) the worst gradient misses it (1.3e-3 to 2.0e-3)."""
    arrays, dy, dh = _inputs(case, seed=4)
    ins, dy, dh = [_t(a) for a in arrays], _t(dy), _t(dh)
    want = kssd.ssd_bwd_plain(*ins, dy, dh)
    hs = kssd.ssd_bwd_plan(1, case[2], 64, case[5], 128)
    states, decay = kssd.ssd_chunk_states_plain(*ins[:4])
    einsum = torch.einsum

    def emulated(mm):
        # the forward's kept states are inputs of the backward kernels:
        # the plain ones here; only the backward's products are emulated
        def passes(*a):
            with monkeypatch.context() as m:
                m.setattr(kssd, "ssd_chunk_states_plain",
                          lambda *_a, **_k: (states, decay))
                m.setattr(torch, "einsum", mm)
                return _passes(*a)
        return _scaled_errors(passes(*ins, dy, dh, hs), want)
    three = emulated(_mm_3xtf32(einsum))
    one = emulated(_mm_tf32(einsum))
    assert max(three.values()) <= GRAD_TOL, three
    assert max(one.values()) > GRAD_TOL, one


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
# mamba2-1.3b's heads at training's 8 x 128, a ragged chunk with h0 and
# dh_final, and 8 groups; N that is no multiple of 4 above one half of
# N (rows of B, C and the states misaligned for 16-byte reads), with P
# 18; every slice size the kernel can take
CARD_HS = [
    ("mamba2-b8-s128", 8, 128, 64, 64, 1, 128, True, False, False),
    ("mamba2-b1-s100-h0-dh", 1, 100, 64, 64, 1, 128, True, True, True),
    ("mamba2-b2-s200-dh", 2, 200, 64, 64, 1, 128, True, False, True),
    ("g8-b1-s200-h0-dh", 1, 200, 64, 64, 8, 128, True, True, True),
    ("s100-g2", 2, 100, 4, 16, 2, 8, True, False, True),
    ("n66-b2-s130-h0-dh", 2, 130, 8, 64, 1, 66, True, True, True),
    ("n90-p18-g2-b1-s200-dh", 1, 200, 4, 18, 2, 90, True, False, True),
    ("n90-b1-s50-h0", 1, 50, 4, 64, 1, 90, True, True, False),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,hs", [(c, hs) for c in CARD_HS
                                     for hs in _divisors(c[3] // c[5])],
                         ids=lambda v: v[0] if isinstance(v, tuple)
                         else f"hs{v}")
def test_bwd_kernels_at_every_slice_on_card(case, hs, dt):
    """The backward kernels at a forced slice size against autograd
    through ``ssd_plain``; two calls bitwise equal."""
    _card()
    dtype = getattr(torch, dt)
    arrays, dy, dh = _inputs(case)
    ins = [_t(a, "cuda", dtype if i in (0, 3, 4) else None)
           for i, a in enumerate(arrays)]
    dy, dh = _t(dy, "cuda", dtype), _t(dh, "cuda")
    _, _, states, decay = kssd._ssd_cuda(*ins, keep=True)
    got = kssd._ssd_bwd_cuda(*ins, dy, dh, states, decay, hs=hs)
    again = kssd._ssd_bwd_cuda(*ins, dy, dh, states, decay, hs=hs)
    torch.cuda.synchronize()
    want, _ = _autograd(kssd.ssd_plain, ins, dy, dh)
    _close(got, want, tol=GPU_TOL[dt])
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_launch_plan_on_card(dt):
    """Three launches; the chunk kernel two blocks an SM, in at most 113 KB
    of shared memory a block.  At 8 x 128 (two chunks, hs 8): a walk block
    a (row, head, half of N) and a C.B^T block a (row, chunk); a dB/dC
    block a (row, chunk, slice, half of N) and a dx block a (row, chunk,
    head); a reduce block a 256 elements of dB and dC, and one a 8 of
    dA's and dD's 2 H warps."""
    _card()
    plan = kssd.ssd_bwd_launch_plan(8, 128, 64, 1, 128, getattr(torch, dt))
    k = plan["kernels"]
    chunk = k["ssd_bwd_chunk"]
    assert plan["launches"] == 3 and plan["hs"] == 8
    assert chunk["blocks_per_sm"] >= 2 and chunk["smem_bytes"] <= 113 * 1024
    assert k["ssd_bwd_state"]["blocks"] == 8 * 64 * 2 + 8 * 2
    assert chunk["blocks"] == 8 * 2 * 8 * 2 + 8 * 2 * 64
    assert k["ssd_bwd_reduce"]["blocks"] == 2 * 8 * 128 * 128 // 256 \
        + 2 * 64 // 8
