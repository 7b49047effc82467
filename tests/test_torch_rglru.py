"""The port's RG-LRU (repro_torch.kernels.rglru).

On the CPU: the plain version against the JAX reference on the same
numpy inputs over the reference's RGLRU_SWEEP (tests/test_kernels.py):
the sequential oracle ``ref.rglru_ref`` at 2e-5 and the associative scan
``ops._rglru_assoc`` at 2e-4, as that file holds them; the decode step
against ``ops.rglru_decode_step``; and the device dispatch.  Not against
the Pallas kernel: it does not trace on this JAX (ROADMAP Queue C).  On
the card (``-m gpu``): the hand-written kernel against the plain
version, in f32 and bf16.

The card's machine has no JAX, so JAX is imported by the ``ref``
fixture and not at the top."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru import (rglru, rglru_decode_step,  # noqa: E402
                                       rglru_plain)

# tests/test_kernels.py's RGLRU_SWEEP (test_sweep_is_the_reference_sweep
# keeps the two equal): B, S, W, block_t, block_w, use_h0
RGLRU_SWEEP = [(2, 64, 32, 16, 32, True), (1, 70, 40, 16, 32, False),
               (3, 128, 8, 64, 8, True)]


def rglru_inputs(B, S, W, use_h0, seed=0):
    """Numpy x, r_gate, i_gate (B,S,W), log_lambda (W,) and h0 (B,W)
    scaled by 0.2, as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)

    def z(*s):
        return rng.standard_normal(s).astype(np.float32)
    x, rg, ig, ll = z(B, S, W), z(B, S, W), z(B, S, W), z(W)
    return x, rg, ig, ll, (z(B, W) * 0.2 if use_h0 else None)


def _torch(arrays, device="cpu", dtype=torch.float32):
    """x and the gates in ``dtype``; log_lambda and h0 stay f32."""
    return [None if a is None else
            torch.from_numpy(a).to(device).to(dtype if i < 3 else
                                               torch.float32)
            for i, a in enumerate(arrays)]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops
    from repro.kernels import ref as ref_mod
    return SimpleNamespace(jnp=jnp, ops=ops, oracle=ref_mod.rglru_ref)


def test_sweep_is_the_reference_sweep(ref):
    from test_kernels import RGLRU_SWEEP as REF
    assert RGLRU_SWEEP == REF


@pytest.mark.parametrize("case", RGLRU_SWEEP)
def test_plain_matches_reference(case, ref):
    B, S, W, _, _, use_h0 = case
    arrays = rglru_inputs(B, S, W, use_h0)
    j = [None if a is None else ref.jnp.asarray(a) for a in arrays]
    h, hf = rglru_plain(*_torch(arrays))
    for (want_h, want_f), tol in ((ref.oracle(*j), 2e-5),
                                  (ref.ops._rglru_assoc(*j), 2e-4)):
        _close(h, want_h, tol)
        _close(hf, want_f, tol)
    assert h.dtype == torch.float32 and hf.dtype == torch.float32


@pytest.mark.parametrize("use_h0", [True, False])
def test_decode_step_matches_reference(ref, use_h0):
    x, rg, ig, ll, h0 = rglru_inputs(3, 1, 24, True, seed=4)
    h0 = h0 if use_h0 else np.zeros_like(h0)
    args = (h0, x[:, 0], rg[:, 0], ig[:, 0], ll)
    want, want_f = ref.ops.rglru_decode_step(
        *(ref.jnp.asarray(a) for a in args))
    got, got_f = rglru_decode_step(*(torch.from_numpy(a) for a in args))
    _close(got, want, 2e-5)
    _close(got_f, want_f, 2e-5)


def test_decode_steps_equal_the_scan():
    """S decode steps from h0 give the prefill's sequence and state."""
    x, rg, ig, ll, h0 = _torch(rglru_inputs(2, 17, 24, True, seed=6))
    hs, hf = rglru_plain(x, rg, ig, ll, h0)
    h = h0
    for s in range(x.shape[1]):
        _, h = rglru_decode_step(h, x[:, s], rg[:, s], ig[:, s], ll)
        _close(h, hs[:, s].numpy(), 2e-5)
    _close(h, hf.numpy(), 2e-5)


def test_cpu_tensors_take_the_plain_version():
    args = _torch(rglru_inputs(1, 9, 16, True))
    before = rglru.launches
    got = rglru(*args)
    want = rglru_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert rglru.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        rglru(*(a.to("meta") for a in args))


def _gpu_cases():
    """(name, B, S, W, use_h0): the sweep, then recurrentgemma-9b's
    width (W 4096) at demo prompts (one chunk: one launch) and long
    prompts over many chunks with a ragged tail (two launches), whose
    time steps do not fill the kernels' last group of in-flight loads;
    the longest at B 3 with h0; and an odd width (bf16 one channel a
    thread)."""
    out = [(f"sweep{i}", B, S, W, use_h0)
           for i, (B, S, W, _, _, use_h0) in enumerate(RGLRU_SWEEP)]
    out += [("rg9b-s5", 1, 5, 4096, False), ("rg9b-s10-h0", 2, 10, 4096, True),
            ("rg9b-s1001", 1, 1001, 4096, True),
            ("rg9b-b3-s2600-h0", 3, 2600, 4096, True),
            ("odd-width", 2, 77, 33, True)]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _gpu_cases(), ids=lambda c: c[0])
def test_kernel_matches_plain_on_card(case, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, B, S, W, use_h0 = case
    args = _torch(rglru_inputs(B, S, W, use_h0, seed=S), "cuda",
                  getattr(torch, dt))
    before = rglru.launches
    h, hf = rglru(*args)
    torch.cuda.synchronize()
    assert rglru.launches == before + 1
    assert h.dtype == args[0].dtype and hf.dtype == torch.float32
    want_h, want_f = rglru_plain(*args)
    # f32: the kernel's expf/sqrtf against torch's, in another order;
    # bf16: h is rounded to bf16 on both sides
    tol = 2e-4 if dt == "float32" else 2e-2
    _close(h, want_h.float().cpu().numpy(), tol)
    _close(hf, want_f.cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [32, 64, 128])
@pytest.mark.parametrize("case", [c for c in _gpu_cases() if c[0] in (
    "sweep1", "rg9b-s10-h0", "rg9b-s1001")], ids=lambda c: c[0])
def test_kernel_at_each_chunk_length_matches_plain_on_card(case, L):
    """Chunk lengths forced, whatever ``CHUNK`` is: one chunk, several,
    many with a ragged tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.rglru import _rglru_cuda
    _, B, S, W, use_h0 = case
    args = _torch(rglru_inputs(B, S, W, use_h0, seed=L), "cuda")
    h, hf = _rglru_cuda(*args, chunk_len=L)
    torch.cuda.synchronize()
    want_h, want_f = rglru_plain(*args)
    _close(h, want_h.cpu().numpy(), 2e-4)
    _close(hf, want_f.cpu().numpy(), 2e-4)


@pytest.mark.parametrize("needs_grad", ["x", "r_gate", "i_gate",
                                        "log_lambda", "h0"])
def test_kernel_refuses_inputs_that_need_grad(needs_grad):
    """The kernels have no backward: the wrapper raises for inputs that
    need a gradient, before it builds or binds anything (so the check
    runs here, on CPU tensors handed to the card's path).  With gradients
    off the check passes and validation goes on."""
    from repro_torch.kernels import rglru as krg
    Bb, S, W = 1, 5, 8
    t = {"x": torch.randn(Bb, S, W), "r_gate": torch.rand(Bb, S, W),
         "i_gate": torch.rand(Bb, S, W), "log_lambda": -torch.rand(W),
         "h0": torch.randn(Bb, W)}
    t[needs_grad].requires_grad_()
    built = krg._fn
    with pytest.raises(RuntimeError, match="no backward"):
        krg._rglru_cuda(t["x"], t["r_gate"], t["i_gate"], t["log_lambda"],
                        t["h0"])
    with torch.no_grad(), pytest.raises(ValueError, match="log_lambda"):
        krg._rglru_cuda(t["x"], t["r_gate"], t["i_gate"],
                        t["log_lambda"][:-1], t["h0"])
    assert krg._fn is built                 # nothing was bound
