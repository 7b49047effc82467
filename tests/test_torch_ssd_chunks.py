"""The SSD kernels' chunk-parallel decomposition, on the CPU.

On the card the SSD is four launches (``csrc/ssd.cu``): each chunk's
C·Bᵀ once per group of heads (``ssd_chunk_cb``; the plain scan forms it
per head), each chunk's own state from zero (``ssd_chunk_state``), the states entering each chunk
(``ssd_state_passing``), and y from a chunk's tokens and its entering
state (``ssd_chunk_scan``).  Here their plain counterparts: composed, they
must equal ``ssd_plain`` at 1e-5 in f32 at the kernels' chunk lengths and
others, on sequences shorter than, equal to and longer than a chunk, with
a ragged last chunk, with and without h0 and D, at G 1 and 2; each piece
must equal the JAX oracle ``ref.ssd_ref`` on the same numpy inputs at
tests/test_kernels.py's 2e-4.  Last, the accuracy question of putting
the products on the tensor cores, answered by emulation: 3xTF32 (what
the kernels run) keeps a mamba2-width SSD within the smoke run's
SCAN_TOL, plain TF32 does not."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd as kssd  # noqa: E402
from test_torch_ssd import SSD_SWEEP, _torch, ssd_inputs  # noqa: E402

CHUNK_TOL = 1e-5     # the same algebra in another association, f32
REF_TOL = 2e-4       # tests/test_kernels.py's SSD tolerance
SCAN_TOL = 2e-4      # chip_smoke.py's f32 SSD tolerance on the card


def _compose(x, dt, A, B, C, D, h0, Q):
    states, decay = kssd.ssd_chunk_states_plain(x, dt, A, B, chunk=Q)
    entering, hf = kssd.ssd_state_passing_plain(states, decay, h0)
    y = kssd.ssd_chunk_scan_plain(x, dt, A, B, C, entering, D, chunk=Q)
    return y, hf


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("use_D", [True, False], ids=["D", "noD"])
@pytest.mark.parametrize("use_h0", [True, False], ids=["h0", "zero"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("length", ["below", "equal", "whole", "ragged"])
@pytest.mark.parametrize("Q", [16, 64, 128])
def test_composition_equals_plain(Q, length, G, use_h0, use_D):
    """Q 64 is the kernels' chunk; 16 and 128 check that the algebra does
    not lean on it.  below: S < Q (the kernels' one-launch path); equal:
    S = Q; whole: three full chunks; ragged: two and a part."""
    S = {"below": Q // 2 + 1, "equal": Q, "whole": 3 * Q,
         "ragged": 2 * Q + 5}[length]
    args = _torch(ssd_inputs(2, S, 4, 8, G, 16, use_D, use_h0, seed=S + G))
    y, hf = _compose(*args, Q)
    want_y, want_h = kssd.ssd_plain(*args)
    _close(y, want_y, CHUNK_TOL)
    _close(hf, want_h, CHUNK_TOL)
    assert y.shape == args[0].shape and y.dtype == torch.float32


@pytest.fixture(scope="module")
def ref():
    """The JAX oracle, on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as ref_mod
    return SimpleNamespace(jnp=jnp, oracle=ref_mod.ssd_ref)


def _oracle(ref, arrays, lo, hi, h0):
    """ref.ssd_ref on tokens [lo, hi) from ``h0`` (numpy or None)."""
    x, dt, A, B, C, D, _ = arrays
    args = (x[:, lo:hi], dt[:, lo:hi], A, B[:, lo:hi], C[:, lo:hi], D, h0)
    y, h = ref.oracle(*(None if a is None else ref.jnp.asarray(a)
                        for a in args))
    return np.asarray(y), np.asarray(h)


@pytest.mark.parametrize("Q", [16, 64])
@pytest.mark.parametrize("case", SSD_SWEEP + [
    (2, 150, 4, 8, 2, 16, 0, True, True)], ids=lambda c: "x".join(
        map(str, c[:6])))
def test_each_piece_matches_the_oracle(case, Q, ref):
    """Chunk c's state is the oracle's final state of that chunk alone
    from zero; the state entering chunk c (and h_final) the oracle's final
    state of the tokens before it from h0; y the oracle's y."""
    B, S, H, P, G, N, _, use_D, use_h0 = case
    arrays = ssd_inputs(B, S, H, P, G, N, use_D, use_h0, seed=7)
    x, dt, A, Bm, Cm, D, h0 = _torch(arrays)
    states, decay = kssd.ssd_chunk_states_plain(x, dt, A, Bm, chunk=Q)
    entering, hf = kssd.ssd_state_passing_plain(states, decay, h0)
    y = kssd.ssd_chunk_scan_plain(x, dt, A, Bm, Cm, entering, D, chunk=Q)
    nc = -(-S // Q)
    assert states.shape == (B, nc, H, P, N) and decay.shape == (B, nc, H)
    zero = np.zeros((B, H, P, N), np.float32)
    for c in range(nc):
        _close(states[:, c], _oracle(ref, arrays, c * Q, (c + 1) * Q,
                                     None)[1], REF_TOL)
        want = (arrays[6] if use_h0 else zero) if c == 0 else \
            _oracle(ref, arrays, 0, c * Q, arrays[6])[1]
        _close(entering[:, c], want, REF_TOL)
    want_y, want_h = _oracle(ref, arrays, 0, S, arrays[6])
    _close(hf, want_h, REF_TOL)
    _close(y, want_y, REF_TOL)


# --- the tensor-core question, by emulation --------------------------------
def _tf32(t):
    """t with the 13 low mantissa bits zeroed: a TF32 operand cut from
    an f32 value, as the kernels cut theirs (``split_tf32`` in
    ``csrc/ssd.cu``)."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _einsum_tf32(eq, a, b):
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _einsum_3xtf32(eq, a, b):
    """a·b as three TF32 products: a_hi·b_hi + a_hi·b_lo + a_lo·b_hi,
    each operand split into its TF32 part and the TF32 part of the rest."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_lo, b_hi))


def _ssd_products_in(mm, x, dt, A, B, C, D, h0, Q=64):
    """The kernels' algebra with each of the four products (the chunk
    state xᵀ·(w∘B), C·Bᵀ, scores·x, C·hᵀ) computed by ``mm``."""
    Bb, S, H, P = x.shape
    rep = H // B.shape[2]
    xf, dtf = kssd._cut(x, Q), kssd._cut(dt, Q)
    Bf, Cf = kssd._cut(B, Q, rep), kssd._cut(C, Q, rep)
    cum = kssd._cum(dt, A, Q)
    last = cum[:, :, -1:]
    w = torch.exp((last - cum).float()) * dtf
    states = mm("bcjhp,bcjhn->bchpn", xf * w[..., None], Bf)
    entering, hf = kssd.ssd_state_passing_plain(
        states, torch.exp(last[:, :, 0].float()), h0)
    above = torch.triu(torch.ones(Q, Q, dtype=torch.bool), diagonal=1)
    decay = torch.exp((cum[:, :, :, None] - cum[:, :, None]).float()
                      .masked_fill(above[None, None, :, :, None],
                                   float("-inf")))
    scores = mm("bcihn,bcjhn->bcijh", Cf, Bf) * decay * dtf[:, :, None]
    y = mm("bcijh,bcjhp->bcihp", scores, xf) + torch.exp(
        cum.float())[..., None] * mm("bcihn,bchpn->bcihp", Cf, entering)
    y = y.reshape(Bb, -1, H, P)[:, :S] + x * D[None, None, :, None]
    return y, hf


def test_3xtf32_holds_scan_tol_and_tf32_does_not():
    """mamba2-1.3b's heads (H 64, P 64, N 128, G 1) at S 640, inputs drawn
    as the smoke run draws them: every product in 3xTF32 stays within
    SCAN_TOL of ``ssd_plain`` (atol and rtol); in plain TF32 it does not."""
    args = _torch(ssd_inputs(1, 640, 64, 64, 1, 128, True, True, seed=3))
    want_y, want_h = kssd.ssd_plain(*args)

    def within(got):
        return all(torch.allclose(a, b, rtol=SCAN_TOL, atol=SCAN_TOL)
                   for a, b in zip(got, (want_y, want_h)))
    assert within(_ssd_products_in(_einsum_3xtf32, *args))
    assert not within(_ssd_products_in(_einsum_tf32, *args))
