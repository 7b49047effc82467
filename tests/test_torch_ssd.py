"""The port's Mamba2 SSD (repro_torch.kernels.ssd).

On the CPU: the plain version against the JAX reference on the same
numpy inputs over the reference's SSD_SWEEP (tests/test_kernels.py) —
the sequential oracle ``ref.ssd_ref``, the Pallas kernel in interpret
mode and ``ops._ssd_chunked`` — at 2e-4, as that file holds them; its
chunk invariance; the decode step against ``ops.ssd_decode_step``; and
the device dispatch.  On the card (``-m gpu``): the hand-written kernel
against the plain version, in f32 and bf16.

The card's machine has no JAX, so JAX is imported by the ``ref``
fixture and not at the top."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd import (ssd, ssd_decode_step,  # noqa: E402
                                     ssd_plain)

TOL = 2e-4
# tests/test_kernels.py's SSD_SWEEP (test_sweep_is_the_reference_sweep
# keeps the two equal): B, S, H, P, G, N, chunk, use_D, use_h0
SSD_SWEEP = [
    (2, 64, 4, 8, 2, 16, 32, True, True),
    (1, 100, 2, 16, 1, 8, 32, False, False),
    (3, 33, 4, 4, 4, 4, 16, True, False),
]


def ssd_inputs(B, S, H, P, G, N, use_D, use_h0, seed=0):
    """Numpy inputs as tests/test_kernels.py draws them: dt softplus'ed,
    A = -exp(0.5 z), B and C scaled by 0.3, h0 by 0.1."""
    rng = np.random.default_rng(seed)

    def z(*s):
        return rng.standard_normal(s).astype(np.float32)
    x, dt_raw = z(B, S, H, P), z(B, S, H)
    dt = np.logaddexp(dt_raw, 0.0).astype(np.float32)
    A = -np.exp(z(H) * 0.5).astype(np.float32)
    Bm, Cm = z(B, S, G, N) * 0.3, z(B, S, G, N) * 0.3
    D = z(H) if use_D else None
    h0 = z(B, H, P, N) * 0.1 if use_h0 else None
    return x, dt, A, Bm, Cm, D, h0


def _torch(arrays, device="cpu", dtype=torch.float32):
    """x, B and C in ``dtype``; dt, A, D and h0 stay f32."""
    out = []
    for i, a in enumerate(arrays):
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(a).to(device)
        out.append(t.to(dtype) if i in (0, 3, 4) else t)
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops
    from repro.kernels import ref as ref_mod
    from repro.kernels.ssd import ssd_pallas
    return SimpleNamespace(jnp=jnp, ops=ops, oracle=ref_mod.ssd_ref,
                           pallas=ssd_pallas)


def test_sweep_is_the_reference_sweep(ref):
    from test_kernels import SSD_SWEEP as REF
    assert SSD_SWEEP == REF


@pytest.mark.parametrize("case", SSD_SWEEP)
def test_plain_matches_reference(case, ref):
    B, S, H, P, G, N, Q, use_D, use_h0 = case
    arrays = ssd_inputs(B, S, H, P, G, N, use_D, use_h0)
    j = [None if a is None else ref.jnp.asarray(a) for a in arrays]
    y, hf = ssd_plain(*_torch(arrays), chunk=Q)
    for want_y, want_h in (ref.oracle(*j),
                           ref.pallas(*j, chunk=Q, interpret=True),
                           ref.ops._ssd_chunked(*j, chunk=Q)):
        _close(y, want_y)
        _close(hf, want_h)
    assert y.dtype == torch.float32 and hf.dtype == torch.float32


@pytest.mark.parametrize("chunk", [12, 16, 24, 48, 64])
def test_plain_is_chunk_invariant(chunk):
    """As tests/test_kernels.py::test_ssd_chunk_invariance: the output
    does not depend on the chunk length (the kernel picks its own)."""
    arrays = ssd_inputs(1, 48, 2, 4, 1, 8, True, True, seed=chunk)
    y1, h1 = ssd_plain(*_torch(arrays), chunk=8)
    y2, h2 = ssd_plain(*_torch(arrays), chunk=chunk)
    _close(y2, y1.numpy())
    _close(h2, h1.numpy())


@pytest.mark.parametrize("G", [1, 2])
def test_decode_step_matches_reference(ref, G):
    B, H, P, N = 3, 4, 8, 16
    x, dt, A, Bm, Cm, D, h0 = ssd_inputs(B, 1, H, P, G, N, True, True,
                                         seed=G)
    args = (h0, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)
    want_y, want_h = ref.ops.ssd_decode_step(
        *(ref.jnp.asarray(a) for a in args))
    y, h = ssd_decode_step(*(torch.from_numpy(a) for a in args))
    _close(y, want_y)
    _close(h, want_h)


def test_decode_steps_equal_the_scan():
    """S decode steps from h0 give the prefill's y and final state."""
    arrays = ssd_inputs(2, 20, 4, 8, 2, 16, True, True, seed=5)
    x, dt, A, Bm, Cm, D, h0 = _torch(arrays)
    y, hf = ssd_plain(x, dt, A, Bm, Cm, D, h0, chunk=8)
    h = h0
    for s in range(x.shape[1]):
        y_t, h = ssd_decode_step(h, x[:, s], dt[:, s], A, Bm[:, s],
                                 Cm[:, s], D)
        _close(y_t, y[:, s].numpy())
    _close(h, hf.numpy())


def test_cpu_tensors_take_the_plain_version():
    args = _torch(ssd_inputs(1, 9, 2, 4, 1, 8, True, False))
    before = ssd.launches
    got = ssd(*args, chunk=4)
    want = ssd_plain(*args, chunk=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ssd.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd(*(None if a is None else a.to("meta") for a in args))


def _gpu_cases():
    """(name, B, S, H, P, G, N, use_D, use_h0): the sweep, mamba2-1.3b's
    heads (H 64, P 64, G 1, N 128) at a demo prompt (one chunk: one
    launch) and across several of the kernels' chunks with a ragged tail
    (four launches; many chunks at B 2 with h0), grouped heads with N
    and P below the kernels' tiles, and P and N that are no multiple of 4
    (element-wise loads and state passing, odd P's stores)."""
    out = [(f"sweep{i}", B, S, H, P, G, N, use_D, use_h0)
           for i, (B, S, H, P, G, N, _, use_D, use_h0) in
           enumerate(SSD_SWEEP)]
    out += [("mamba2-s7", 1, 7, 64, 64, 1, 128, True, False),
            ("mamba2-s200-h0", 2, 200, 64, 64, 1, 128, True, True),
            ("mamba2-b2-s1000-h0", 2, 1000, 64, 64, 1, 128, True, True),
            ("groups", 2, 130, 8, 32, 4, 64, False, True),
            ("odd-dims", 2, 150, 2, 5, 1, 7, True, True)]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _gpu_cases(), ids=lambda c: c[0])
def test_kernel_matches_plain_on_card(case, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, B, S, H, P, G, N, use_D, use_h0 = case
    args = _torch(ssd_inputs(B, S, H, P, G, N, use_D, use_h0, seed=S),
                  "cuda", getattr(torch, dt))
    before = ssd.launches
    y, hf = ssd(*args)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert y.dtype == args[0].dtype and hf.dtype == torch.float32
    want_y, want_h = ssd_plain(*args)
    # bf16: y is rounded to bf16 on both sides (2^-8 relative)
    tol = TOL if dt == "float32" else 2e-2
    _close(y, want_y.float().cpu().numpy(), tol)
    _close(hf, want_h.cpu().numpy(), tol)



@pytest.mark.parametrize("needs_grad", ["x", "dt", "A", "B", "C", "D", "h0"])
def test_kernel_refuses_inputs_that_need_grad(needs_grad):
    """The raw launch has no backward (inputs that need a gradient go
    through ``ssd``, whose ``SSDFunction`` carries it): it raises for
    them before it builds or binds anything (so the check runs here, on
    CPU tensors handed to the card's path).  With gradients off the check
    passes and validation goes on."""
    from repro_torch.kernels import ssd as kssd
    Bb, S, H, P, G, N = 1, 5, 2, 4, 1, 4
    t = {"x": torch.randn(Bb, S, H, P), "dt": torch.rand(Bb, S, H),
         "A": -torch.rand(H), "B": torch.randn(Bb, S, G, N),
         "C": torch.randn(Bb, S, G, N), "D": torch.randn(H),
         "h0": torch.randn(Bb, H, P, N)}
    t[needs_grad].requires_grad_()
    built = kssd._fn
    with pytest.raises(RuntimeError, match="no backward"):
        kssd._ssd_cuda(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"],
                       t["h0"])
    with torch.no_grad(), pytest.raises(ValueError, match="shapes"):
        kssd._ssd_cuda(t["x"], t["dt"][:, :-1], t["A"], t["B"], t["C"],
                       t["D"], t["h0"])
    assert kssd._fn is built                # nothing was bound
