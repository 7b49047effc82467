"""The attention backward of the port (repro_torch.kernels.attention).

On the CPU: ``attention_bwd_plain`` (FlashAttention-2's algebra written
out, from the forward's o and row log-sum-exp) and ``AttentionFunction``
(``attention`` with inputs that need a gradient) against ``jax.vjp`` of
the reference oracle ``repro.kernels.ref.attention_ref`` and against
autograd through ``attention_plain``, on the same numpy inputs.  f32 to
1e-5 (the same f32 algebra, summed in another order); bf16 to 2e-2 of
the largest gradient entry (inputs and outputs rounded to bf16, 2^-8
relative each).  On the card (``-m gpu``): the backward kernels and the
forward's lse against the plain versions; the bf16 tensor-core route at
forced row splits 1, 2 and 4, and two calls bitwise equal.

The card's machine has no JAX, so JAX is imported by the ``ref`` fixture
and not at the top."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as fa  # noqa: E402

# name, Hq, Hkv, D, causal, window, softcap, prefix: GQA groups of 1, 2,
# 3 and 16 (MQA) at head dims 64, 128 and 256, with causal, window and
# softcap
CASES = [
    ("g1-d64-causal", 4, 4, 64, True, 0, 0.0, None),
    ("g3-d64-window", 6, 2, 64, True, 7, 0.0, None),
    ("g16-d64-softcap", 16, 1, 64, True, 0, 30.0, None),
    ("g1-d256-window-softcap", 2, 2, 256, True, 5, 20.0, None),
    ("g3-d256-causal", 3, 1, 256, True, 0, 0.0, None),
    ("g16-d256-window", 16, 1, 256, True, 9, 0.0, None),
    ("g3-d64-prefix", 6, 2, 64, True, 0, 0.0, 6),
    ("g1-d64-full", 4, 4, 64, False, 0, 0.0, None),
    ("g2-d128-causal", 4, 2, 128, True, 0, 0.0, None),
]
# the cases the encoder-decoder and the VLM add, kept apart from CASES
# (chip_smoke.py's BWD_SWEEP mirrors those): name, Hq, Hkv, D, causal,
# window, softcap, prefix, T.  Cross attention's S queries against T
# keys, more (ragged tiles on both axes) and fewer; an encoder's
# non-causal self-attention; paligemma's prefix-LM at MQA 8/1 of 256
CROSS_CASES = [
    ("cross-g1-d64-t50", 4, 4, 64, False, 0, 0.0, None, 50),
    ("cross-g3-d64-t9", 6, 2, 64, False, 0, 0.0, None, 9),
    ("encoder-g1-d64", 4, 4, 64, False, 0, 0.0, None, 21),
    ("prefix-g8-d256", 8, 1, 256, True, 0, 0.0, 12, 21),
]
B, S = 2, 21
F32_TOL = 1e-5
BF16_REL = 2e-2


@pytest.fixture(scope="module")
def ref():
    """The JAX oracle's gradient: (q, k, v, do) numpy -> (dq, dk, dv)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ref import attention_ref

    def grads(q, k, v, do, dt, **kw):
        def f(q, k, v):
            return attention_ref(q, k, v, **kw)
        arrs = [jnp.asarray(a, dt) for a in (q, k, v)]
        out, vjp = jax.vjp(f, *arrs)
        return [np.asarray(g, np.float32)
                for g in vjp(jnp.asarray(do, dt))]
    return grads


def _inputs(case, seed=0, T=S):
    _, Hq, Hkv, D, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D),
                      (B, S, Hq, D))]


def _kw(case):
    _, _, _, _, causal, window, softcap, prefix = case[:8]
    return dict(causal=causal, window=window, softcap=softcap,
                prefix_len=prefix)


def _t(a, dt, grad=False, device="cpu"):
    x = torch.from_numpy(a).to(device=device, dtype=getattr(torch, dt))
    return x.requires_grad_() if grad else x


def _close(got, want, dt):
    got = [g.detach().float().cpu().numpy() for g in got]
    for name, g, w in zip("qkv", got, want):
        if dt == "float32":
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"d{name}")
        else:
            scale = float(np.abs(w).max())
            err = float(np.abs(g - w).max())
            assert err <= BF16_REL * scale, (f"d{name}", err, scale)


def _by(how, q, k, v, do, kw):
    """(dq, dk, dv) through the backward under test."""
    if how == "bwd_plain":
        o, lse = fa.attention_fwd_plain(q, k, v, **kw)
        return fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = fa.attention(q, k, v, **kw)              # AttentionFunction
    assert out.grad_fn is not None and "AttentionFunction" in \
        type(out.grad_fn).__name__
    return torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["bwd_plain", "function"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_backward_matches_jax_vjp_and_autograd(ref, case, how, dt):
    q, k, v, do = _inputs(case)
    kw = _kw(case)
    got = _by(how, *(_t(a, dt) for a in (q, k, v, do)), kw)
    assert all(g.dtype == getattr(torch, dt) for g in got)
    _close(got, ref(q, k, v, do, dt, **kw), dt)
    # autograd through the plain forward on the same inputs
    tq, tk, tv = (_t(a, dt, grad=True) for a in (q, k, v))
    want = torch.autograd.grad(fa.attention_plain(tq, tk, tv, **kw),
                               (tq, tk, tv), _t(do, dt))
    _close(got, [w.float().numpy() for w in want], dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["bwd_plain", "function"])
@pytest.mark.parametrize("case", CROSS_CASES, ids=lambda c: c[0])
def test_cross_and_prefix_backward_match_jax_vjp(ref, case, how, dt):
    """CROSS_CASES: the plain backward and ``AttentionFunction`` against
    ``jax.vjp`` of the oracle and autograd through the plain forward."""
    q, k, v, do = _inputs(case, seed=4, T=case[8])
    kw = _kw(case)
    got = _by(how, *(_t(a, dt) for a in (q, k, v, do)), kw)
    _close(got, ref(q, k, v, do, dt, **kw), dt)
    tq, tk, tv = (_t(a, dt, grad=True) for a in (q, k, v))
    want = torch.autograd.grad(fa.attention_plain(tq, tk, tv, **kw),
                               (tq, tk, tv), _t(do, dt))
    _close(got, [w.float().numpy() for w in want], dt)


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: c[0])
def test_forward_lse_is_the_masked_logsumexp(case):
    """attention_fwd_plain's o equals attention_plain's, and its lse is
    logsumexp over the visible scaled, soft-capped logits."""
    q, k, v, _ = (_t(a, "float32") for a in _inputs(case, seed=1))
    kw = _kw(case)
    o, lse = fa.attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o, fa.attention_plain(q, k, v, **kw),
                               rtol=F32_TOL, atol=F32_TOL)
    x, mask = fa._logits(q, k, q_offset=0, **kw)
    want = torch.logsumexp(torch.where(mask[:, None], x, -torch.inf), -1)
    assert lse.shape == (B, q.shape[2], S)
    torch.testing.assert_close(lse, want, rtol=F32_TOL, atol=F32_TOL)


def test_row_that_sees_no_key_gets_zero_gradient():
    """More queries than keys under a window: queries 10.. see no key.
    Their lse is NEG_INF, o is 0, and every gradient is finite; the dead
    rows' dq is 0, and the rest agree with autograd through the plain
    forward."""
    case = ("dead", 4, 2, 64, True, 3, 0.0, None)
    q, k, v, do = (_t(a, "float32") for a in _inputs(case, seed=2, T=8))
    kw = _kw(case)
    o, lse = fa.attention_fwd_plain(q, k, v, **kw)
    dead = torch.arange(S) >= 8 + 3 - 1
    assert bool((lse[:, :, dead] == fa.NEG_INF).all())
    assert bool((o[:, dead] == 0).all())
    dq, dk, dv = fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert bool((dq[:, dead] == 0).all())
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.attention_plain(tq, tk, tv, **kw)
    # the plain forward spreads a dead row over every key: leave those out
    want = torch.autograd.grad(out[:, ~dead], (tq, tk, tv), do[:, ~dead])
    for g, w in zip((dq[:, ~dead], dk, dv), (want[0][:, ~dead], *want[1:])):
        torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_gradient_needs_offset_zero():
    q, k, v = (torch.randn(1, 4, 2, 64, requires_grad=True)
               for _ in range(3))
    with pytest.raises(RuntimeError, match="q_offset 0"):
        fa.attention(q, k, v, q_offset=3)
    with pytest.raises(RuntimeError, match="q_offset 0"):
        fa.attention(q, k, v, q_offset=torch.zeros(1, dtype=torch.int32))
    with torch.no_grad():                   # serving: no gradient asked
        assert fa.attention(q, k, v, q_offset=3).shape == q.shape


def test_cpu_backward_launches_nothing():
    q, k, v = (torch.randn(1, 8, 2, 64, requires_grad=True)
               for _ in range(3))
    before = (fa.attention.launches, fa.attention_bwd.launches)
    fa.attention(q, k, v).sum().backward()
    assert (fa.attention.launches, fa.attention_bwd.launches) == before
    assert all(t.grad is not None for t in (q, k, v))


def test_chip_smoke_sweeps_these_cases():
    """chip_smoke.py's phase 2 runs the backward kernels on these cases."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    assert chip_smoke.BWD_SWEEP == [c[1:] for c in CASES]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
GPU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the training shapes: qwen1.5-0.5b's heads at batch 8 x 128 and 4 x 1024,
# paligemma-3b's prefix-LM (MQA 8/1 of 256, 256 patches) at 8 x 384 and
# recurrentgemma-9b's local attention (MQA 16/1 of 256, window 2048) at
# 8 x 128: name, B, S, Hq, Hkv, D, masks
TRAIN_SHAPES = [("qwen-b8-s128", 8, 128, 16, 16, 64, {}),
                ("qwen-b4-s1024", 4, 1024, 16, 16, 64, {}),
                ("paligemma-b8-s384", 8, 384, 8, 1, 256,
                 dict(prefix_len=256)),
                ("recurrentgemma-b8-s128", 8, 128, 16, 1, 256,
                 dict(window=2048))]


def _card(dt, *arrays):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return [_t(a, dt, device="cuda") for a in arrays]


def _card_close(got, want, dt):
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        assert err <= GPU_TOL[dt] * max(scale, 1.0), (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_bwd_kernel_matches_plain_on_card(case, dt):
    q, k, v, do = _card(dt, *_inputs(case))
    kw = _kw(case)
    o, lse = fa.attention_fwd_plain(q, k, v, **kw)
    before = fa.attention_bwd.launches
    got = fa.attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.attention_bwd.launches == before + 1
    _card_close(got, fa.attention_bwd_plain(q, k, v, o, lse, do, **kw), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,n_split", [
    ("float32", None), ("bfloat16", 1), ("bfloat16", 2),
    ("bfloat16", None)], ids=["f32", "bf16-1", "bf16-2", "bf16-planned"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_forward_lse_on_card(case, dt, n_split):
    """The forward kernel's lse: unsplit (f32 always runs unsplit), and
    split across blocks (bf16), where attn_combine writes it."""
    q, k, v, _ = _card(dt, *_inputs(case))
    kw = _kw(case)
    o, lse = fa._attention_cuda(q, k, v, n_split=n_split, with_lse=True,
                                **kw)
    torch.cuda.synchronize()
    want_o, want_lse = fa.attention_fwd_plain(q, k, v, **kw)
    _card_close([o], [want_o], dt)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CROSS_CASES, ids=lambda c: c[0])
def test_cross_and_prefix_bwd_kernels_match_plain_on_card(case, dt):
    """CROSS_CASES on the card: the forward kernel's o and lse (unsplit,
    and at 2 key splits in bf16), then the backward kernels on them,
    against the plain versions."""
    q, k, v, do = _card(dt, *_inputs(case, seed=4, T=case[8]))
    kw = _kw(case)
    want_o, want_lse = fa.attention_fwd_plain(q, k, v, **kw)
    for n_split in ((1, 2) if dt == "bfloat16" else (1,)):
        o, lse = fa._attention_cuda(q, k, v, n_split=n_split,
                                    with_lse=True, **kw)
        torch.cuda.synchronize()
        _card_close([o], [want_o], dt)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    before = fa.attention_bwd.launches
    got = fa.attention_bwd(q, k, v, want_o, want_lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.attention_bwd.launches == before + 1
    _card_close(got, fa.attention_bwd_plain(q, k, v, want_o, want_lse, do,
                                            **kw), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda c: c[0])
def test_attention_function_on_card_at_training_shapes(shape, dt):
    _, nb, s, Hq, Hkv, D, kw = shape
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(x).astype(np.float32)
              for x in ((nb, s, Hq, D), (nb, s, Hkv, D), (nb, s, Hkv, D),
                        (nb, s, Hq, D))]
    q, k, v, do = _card(dt, *arrays)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (fa.attention.launches, fa.attention_bwd.launches)
    got = torch.autograd.grad(fa.attention(q, k, v, **kw), (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.attention.launches, fa.attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(fa.attention_plain(q, k, v, **kw),
                               (q, k, v), do)
    _card_close(got, want, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("case", CASES + CROSS_CASES, ids=lambda c: c[0])
def test_tc_bwd_matches_plain_at_forced_splits(case, n_split):
    """The bf16 tensor-core route (``bwd_plan``'s ``"tc"``) with its dK/dV
    rows forced into 1, 2 and 4 splits (more splits than row tiles leave
    some empty), against the plain backward on the plain forward's o and
    lse."""
    T = case[8] if len(case) > 8 else S
    q, k, v, do = _card("bfloat16", *_inputs(case, seed=5, T=T))
    kw = _kw(case)
    assert fa.bwd_plan(B, S, T, q.shape[2], k.shape[2], q.shape[3],
                       q.dtype)[0] == "tc"
    o, lse = fa.attention_fwd_plain(q, k, v, **kw)
    got = fa._attention_bwd_cuda(q, k, v, o, lse, do, n_split=n_split, **kw)
    torch.cuda.synchronize()
    _card_close(got, fa.attention_bwd_plain(q, k, v, o, lse, do, **kw),
                "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dt,n_split", [("float32", 1), ("bfloat16", 1),
                                        ("bfloat16", 4)])
@pytest.mark.parametrize("shape", TRAIN_SHAPES[2:], ids=lambda c: c[0])
def test_bwd_kernel_repeats_bitwise(shape, dt, n_split):
    """Two calls on the same inputs give the same bits (no atomics; the
    split's partials summed in a fixed order)."""
    _, nb, s, Hq, Hkv, D, kw = shape
    rng = np.random.default_rng(6)
    q, k, v, do = _card(dt, *(rng.standard_normal(x).astype(np.float32)
                              for x in ((nb, s, Hq, D), (nb, s, Hkv, D),
                                        (nb, s, Hkv, D), (nb, s, Hq, D))))
    o, lse = fa._attention_cuda(q, k, v, with_lse=True, **kw)
    first = fa._attention_bwd_cuda(q, k, v, o, lse, do, n_split=n_split,
                                   **kw)
    again = fa._attention_bwd_cuda(q, k, v, o, lse, do, n_split=n_split,
                                   **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
