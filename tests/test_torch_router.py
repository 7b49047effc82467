"""The port's MoE router top-k (repro_torch.kernels.moe_router).

On the CPU: the plain version against the Pallas kernel in interpret
mode and against ``ref.router_topk_ref`` on the same numpy logits, over
the reference's (T, E) x k grid (tests/test_kernels.py) plus granite's
(64, 40, 8) and deepseek's (64, 64, 6): indices exactly equal, weights
and probabilities within rtol 1e-5 / atol 1e-6 (f32 on both sides, sums
in another order).  Ties go to the lowest expert index.  On the card
(``-m gpu``): the hand-written kernel against the plain version.

The card's machine has no JAX, so JAX is imported by the ``ref``
fixture and not at the top."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_router import (router_topk,  # noqa: E402
                                            router_topk_plain)

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
    before = router_topk.launches
    got = router_topk(x, 8)
    for a, b in zip(got, router_topk_plain(x, 8)):
        assert torch.equal(a, b)
    assert router_topk.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        router_topk(x.to("meta"), 8)


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


@pytest.mark.gpu
@pytest.mark.parametrize("TE,k", CASES + [((4, 40), 8), ((384, 40), 8),
                                          ((7, 512), 32), ((33, 1), 1)],
                         ids=lambda c: str(c))
def test_kernel_matches_plain_on_card(TE, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    T, E = TE
    x = torch.from_numpy(_logits(T, E, seed=3)).cuda()
    before = router_topk.launches
    w, idx, probs = router_topk(x, k)
    torch.cuda.synchronize()
    assert router_topk.launches == before + 1
    pw, pidx, pprobs = router_topk_plain(x, k)
    swaps, bad = ties_within(idx.cpu().numpy(), pidx.cpu().numpy(),
                             pprobs.cpu().numpy())
    assert not bad, f"index swaps beyond a tie: {bad}"
    if swaps:
        print("ties (row, pos, kernel, plain, p_kernel, p_plain):", swaps)
    torch.testing.assert_close(probs, pprobs, rtol=RTOL, atol=ATOL)
    if not swaps:
        torch.testing.assert_close(w, pw, rtol=RTOL, atol=ATOL)
