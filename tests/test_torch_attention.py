"""The port's attention (repro_torch.kernels.attention).

On the CPU: the plain version against the JAX reference on the same
numpy inputs — the Pallas kernel in interpret mode for whole-prompt
prefill, ``ops._attention_chunked`` for a chunk at a scalar offset and
``ops._attention_decode`` for (B,) decode positions — at the tolerances
of tests/test_kernels.py (2e-5 f32, 2e-2 bf16), and the device dispatch.
On the card (``-m gpu``): the hand-written kernel against the plain
version on the same inputs.

The card's machine has no JAX, so JAX is imported by the ``ref``
fixture (the CPU parity tests skip without it) and not at the top."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import (attention,  # noqa: E402
                                           attention_plain)

# tests/test_kernels.py's ATTN_SWEEP (that module imports JAX at the top;
# test_sweep_is_the_reference_sweep keeps the two equal)
ATTN_SWEEP = [
    # S, T, Hq, Hkv, D, causal, window, softcap, prefix, dtype
    (64, 64, 4, 2, 16, True, 0, 0.0, None, "float32"),
    (128, 128, 4, 4, 32, True, 32, 0.0, None, "float32"),
    (96, 96, 8, 1, 64, True, 0, 30.0, None, "float32"),
    (80, 80, 4, 2, 16, True, 0, 0.0, 24, "float32"),
    (200, 200, 2, 2, 16, True, 0, 0.0, None, "float32"),
    (64, 64, 2, 2, 16, False, 0, 0.0, None, "float32"),
    (128, 128, 4, 2, 32, True, 0, 0.0, None, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# on the card the kernel sums in another order than the plain version
GPU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B = 2


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops
    from repro.kernels.flash_attention import flash_attention
    return SimpleNamespace(jnp=jnp, ops=ops, flash_attention=flash_attention,
                           arr=lambda a, dt: jnp.asarray(a, dt))


def _torch(a, dt, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dt))


def _check(got, want, dt, tol=TOL):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol[dt], atol=tol[dt])


def _chunk_case(case):
    """A query chunk inside the sweep case's key range: (S, offset)."""
    S, T = case[0], case[1]
    Sc = min(24, S // 2)
    return Sc, (T - Sc) // 2


def _decode_positions(T):
    return np.asarray([0, T // 2, T - 1], np.int32)


def test_sweep_is_the_reference_sweep(ref):
    from test_kernels import ATTN_SWEEP as REF
    assert ATTN_SWEEP == REF


@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_plain_prefill_matches_pallas_interpret(case, ref):
    S, T, Hq, Hkv, D, causal, window, softcap, prefix, dt = case
    q, k, v = _data(1, (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    want = ref.flash_attention(
        ref.arr(q, dt), ref.arr(k, dt), ref.arr(v, dt), causal=causal,
        window=window, softcap=softcap, prefix_len=prefix, interpret=True,
        block_q=64, block_k=64)
    got = attention_plain(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                          causal=causal, window=window, softcap=softcap,
                          prefix_len=prefix)
    _check(got, want, dt)


@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_plain_chunk_matches_xla_chunked(case, ref):
    _, T, Hq, Hkv, D, causal, window, softcap, prefix, dt = case
    Sc, off = _chunk_case(case)
    q, k, v = _data(2, (B, Sc, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    pl_arr = None if prefix is None else ref.jnp.asarray(prefix)
    want = ref.ops._attention_chunked(
        ref.arr(q, dt), ref.arr(k, dt), ref.arr(v, dt), causal=causal,
        window=window, softcap=softcap, q_offset=off, prefix_len=pl_arr,
        kv_chunk=48)
    got = attention_plain(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                          causal=causal, window=window, softcap=softcap,
                          q_offset=off, prefix_len=prefix)
    _check(got, want, dt)


@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_plain_decode_matches_xla_decode(case, ref):
    _, T, Hq, Hkv, D, causal, window, softcap, prefix, dt = case
    pos = _decode_positions(T)
    n = len(pos)
    q, k, v = _data(3, (n, 1, Hq, D), (n, T, Hkv, D), (n, T, Hkv, D))
    want = ref.ops._attention_decode(
        ref.arr(q, dt), ref.arr(k, dt), ref.arr(v, dt), causal=causal,
        window=window, softcap=softcap, q_offset=ref.jnp.asarray(pos),
        prefix_len=None if prefix is None else ref.jnp.asarray(prefix))
    got = attention_plain(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                          causal=causal, window=window, softcap=softcap,
                          q_offset=torch.from_numpy(pos), prefix_len=prefix)
    _check(got, want, dt)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _data(4, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    before = attention.launches
    got = attention(_torch(q, "float32"), _torch(k, "float32"),
                    _torch(v, "float32"), q_offset=torch.tensor([0]))
    want = attention_plain(_torch(q, "float32"), _torch(k, "float32"),
                           _torch(v, "float32"))
    assert torch.equal(got, want)
    assert attention.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        attention(*(_torch(a, "float32").to("meta") for a in (q, k, v)))


def _gpu_cases():
    """(name, S, T, Hq, Hkv, D, causal, window, softcap, prefix, offset)
    from the sweep: whole prompt, a short prompt (2 to 16 tokens, which
    the kernel runs one query row per block, as the launcher's demo
    does), a chunk, and (B,) decode positions."""
    out = []
    for i, case in enumerate(ATTN_SWEEP):
        S, T, Hq, Hkv, D, causal, window, softcap, prefix, _ = case
        Sc, off = _chunk_case(case)
        Ss = (2, 5, 10, 16)[i % 4]
        out += [(f"prefill{i}", S, T, Hq, Hkv, D, causal, window, softcap,
                 prefix, 0),
                (f"short{i}", Ss, Ss, Hq, Hkv, D, causal, window, softcap,
                 prefix, 0),
                (f"chunk{i}", Sc, T, Hq, Hkv, D, causal, window, softcap,
                 prefix, off),
                (f"decode{i}", 1, T, Hq, Hkv, D, causal, window, softcap,
                 prefix, "vector")]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _gpu_cases(), ids=lambda c: c[0])
def test_kernel_matches_plain_on_card(case, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, S, T, Hq, Hkv, D, causal, window, softcap, prefix, off = case
    nb = 3 if off == "vector" else B
    q, k, v = (_torch(a, dt, "cuda") for a in _data(
        5, (nb, S, Hq, D), (nb, T, Hkv, D), (nb, T, Hkv, D)))
    if off == "vector":
        off = torch.from_numpy(_decode_positions(T)).cuda()
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off,
              prefix_len=prefix)
    before = attention.launches
    got = attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    _check(got, attention_plain(q, k, v, **kw).float().cpu().numpy(), dt,
           GPU_TOL)
