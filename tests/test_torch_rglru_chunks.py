"""The RG-LRU kernels' two passes over time chunks, on the CPU.

On the card the RG-LRU is two launches (``csrc/rglru_scan.cu``): each
chunk's pair (A_c = Π aₜ, its end state e_c from zero) in
``rglru_chunk_summary``, then ``rglru_chunk_apply`` folds the earlier
pairs into the entering state and runs the chunk again.  Here their plain
counterparts: composed, they must equal ``rglru_plain`` at 1e-5 in f32 at
the kernels' chunk lengths and others, on sequences shorter than, equal
to and longer than a chunk, with a ragged last chunk, with and without
h0; each piece must equal the JAX oracle ``ref.rglru_ref`` on the same
numpy inputs at tests/test_kernels.py's 2e-5."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rglru as krg  # noqa: E402
from test_torch_rglru import RGLRU_SWEEP, _torch, rglru_inputs  # noqa: E402

CHUNK_TOL = 1e-5     # the same recurrence in another association, f32
REF_TOL = 2e-5       # tests/test_kernels.py's RG-LRU tolerance


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("use_h0", [True, False], ids=["h0", "zero"])
@pytest.mark.parametrize("length", ["below", "equal", "whole", "ragged"])
@pytest.mark.parametrize("L", [16, 32, 64, 128])
def test_composition_equals_plain(L, length, use_h0):
    """L 32 is the kernels' chunk; the others check that the algebra does
    not lean on it.  below: S < L (the kernels' one-launch path); equal:
    S = L; whole: three full chunks; ragged: two and a part."""
    S = {"below": L // 2 + 1, "equal": L, "whole": 3 * L,
         "ragged": 2 * L + 5}[length]
    x, rg, ig, ll, h0 = _torch(rglru_inputs(2, S, 24, use_h0, seed=S))
    A, e = krg.rglru_chunk_summary_plain(x, rg, ig, ll, chunk=L)
    assert A.shape == e.shape == (2, -(-S // L), 24)
    h, hf = krg.rglru_chunk_apply_plain(x, rg, ig, ll, A, e, h0, chunk=L)
    want_h, want_f = krg.rglru_plain(x, rg, ig, ll, h0)
    _close(h, want_h, CHUNK_TOL)
    _close(hf, want_f, CHUNK_TOL)
    assert h.shape == x.shape and h.dtype == torch.float32


@pytest.fixture(scope="module")
def ref():
    """The JAX oracle, on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as ref_mod
    return SimpleNamespace(jnp=jnp, oracle=ref_mod.rglru_ref)


def _oracle(ref, x, rg, ig, ll, h0):
    h, hf = ref.oracle(*(None if a is None else ref.jnp.asarray(a)
                         for a in (x, rg, ig, ll, h0)))
    return np.asarray(h), np.asarray(hf)


@pytest.mark.parametrize("L", [16, 32, 64])
@pytest.mark.parametrize("case", RGLRU_SWEEP + [(3, 150, 24, 0, 0, True)],
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_each_piece_matches_the_oracle(case, L, ref):
    """Chunk c's end state e_c is the oracle's final state of that chunk
    alone from zero, its product A_c the oracle's final state of the
    chunk with x = 0 from a state of ones; the second pass's h and h_final
    the oracle's from h0."""
    B, S, W, _, _, use_h0 = case
    x, rg, ig, ll, h0 = rglru_inputs(B, S, W, use_h0, seed=11)
    A, e = krg.rglru_chunk_summary_plain(*_torch((x, rg, ig, ll)), chunk=L)
    ones = np.ones((B, W), np.float32)
    for c in range(-(-S // L)):
        t = slice(c * L, (c + 1) * L)
        _close(e[:, c], _oracle(ref, x[:, t], rg[:, t], ig[:, t], ll,
                                None)[1], REF_TOL)
        _close(A[:, c], _oracle(ref, 0 * x[:, t], rg[:, t], ig[:, t], ll,
                                ones)[1], REF_TOL)
    h, hf = krg.rglru_chunk_apply_plain(*_torch((x, rg, ig, ll)), A, e,
                                        None if h0 is None
                                        else torch.from_numpy(h0), chunk=L)
    want_h, want_f = _oracle(ref, x, rg, ig, ll, h0)
    _close(h, want_h, REF_TOL)
    _close(hf, want_f, REF_TOL)

