"""The LM head's loss over the whole vocabulary in the port
(``repro_torch.models.common.chunked_ce_loss`` with ``tp`` None:
``head_loss``, ``HeadLossFunction`` and the ``cross_entropy`` kernel's
plain version).

On the CPU, with seeded numpy inputs, one parametrised test over tied and
untied tables, softcap 0 and 30, z-loss 0 and 1e-4, bf16 and f32 compute:
13 positions in chunks of 4 (a short last chunk), the first chunk's
targets all ``ignore_id`` and some more, an upstream gradient of 2.0.
The loss, ``ce``, ``z_loss``, ``tokens``, dh and d(table) against

* the reference's ``chunked_ce_loss`` and ``jax.grad`` of it: the loss
  terms at rtol 1e-5 (bf16 2e-4: the products are rounded to bf16 by
  another library, and the logits' sums follow), each gradient within
  1e-5 of its largest entry (bf16 2e-2: a logit's gradient rounded to
  bf16 moves by up to 2^-8 of itself when the f32 value beneath it moves
  by an ulp);
* a direct f32 autograd formula over the same (bf16-rounded) product,
  (B·S, V) logits at once: the loss terms at rtol 1e-5, each gradient
  within 1e-5 of its largest entry (bf16 1e-2: the formula rounds
  d(table)'s product over all 26 rows to bf16 once, the port each of the
  4 chunks' products, as the chunked chain did, before their f32 sum;
  5 roundings of up to 2^-9 each).

Also: a call without a gradient gives the same loss and forms none (no
``HeadLossFunction`` in the graph, the kernel asked for no gradient);
the kernel's launch counter stays 0 on the CPU; the plain kernel
function against the formula where V is no multiple of 8 and targets
fall below 0; the dry run's fake tensors take the card's
branch, allocate one (R, V) buffer in the compute dtype and no f32
(R, V) tensor, and add ``kernels/cost.py``'s count to the tally; the
wrapper's checks raise before anything is built.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels import cross_entropy as kce  # noqa: E402
from repro_torch.models import common  # noqa: E402

B, S, D, V, CHUNK = 2, 13, 16, 101, 4
IGNORE = -1
G = 2.0
CASES = [(tie, cap, z, dt) for tie in (True, False) for cap in (0.0, 30.0)
         for z in (0.0, 1e-4) for dt in ("float32", "bfloat16")]


def _cfgs(tie, cap, dt):
    over = dict(vocab=V, d_model=D, tie_embeddings=tie, logit_softcap=cap,
                compute_dtype=dt, param_dtype="float32")
    return (configs.get("qwen1.5-0.5b").replace(**over),
            jconfigs.get("qwen1.5-0.5b").replace(**over))


def _inputs(tie, seed=0):
    """(h (B,S,D) f32, table f32, targets (B,S) int64) from numpy: logits
    of a few units, so that a softcap of 30 bends them."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    shape = (V, D) if tie else (D, V)
    table = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    t = rng.integers(0, V, (B, S))
    t[:, :CHUNK] = IGNORE                 # the first chunk wholly ignored
    t[0, 7] = IGNORE
    t[1, 12] = IGNORE                     # in the short last chunk
    return h, table, t.astype(np.int64)


def _port(cfg, h, table, t, z, grad=True):
    """(loss, ce, z, tokens, dh, dtable) of the port, upstream G."""
    key = "embedding" if cfg.tie_embeddings else "head"
    th = torch.from_numpy(h).to(getattr(torch, cfg.compute_dtype))
    tw = torch.from_numpy(table)
    p = {key: tw.requires_grad_(grad)}
    loss, met = common.chunked_ce_loss(cfg, p, th.requires_grad_(grad),
                                       torch.from_numpy(t), chunk=CHUNK,
                                       z_coef=z, ignore_id=IGNORE)
    grads = (torch.autograd.grad(loss * G, (th, tw)) if grad
             else (None, None))
    return (loss, met["ce"], met["z_loss"], met["tokens"]) + grads


def _reference(jcfg, h, table, t, z):
    key = "embedding" if jcfg.tie_embeddings else "head"
    hj = jnp.asarray(h).astype(jcfg.compute_dtype)

    def f(hh, w):
        loss, met = jcommon.chunked_ce_loss(jcfg, {key: w}, hh,
                                            jnp.asarray(t), chunk=CHUNK,
                                            z_coef=z, ignore_id=IGNORE)
        return loss * G, (loss, met)
    (_, (loss, met)), (dh, dw) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(hj, jnp.asarray(table))
    return (float(loss), float(met["ce"]), float(met["z_loss"]),
            int(met["tokens"]), np.asarray(dh.astype(jnp.float32)),
            np.asarray(dw))


def _formula(cfg, h, table, t, z):
    """The loss by autograd over all (B·S, V) f32 logits at once: the
    product in the compute dtype, then f32."""
    cdt = getattr(torch, cfg.compute_dtype)
    th = torch.from_numpy(h).to(cdt).requires_grad_()
    tw = torch.from_numpy(table).requires_grad_()
    w = tw.t() if cfg.tie_embeddings else tw
    x = (th.reshape(-1, D) @ w.to(cdt)).float()
    if cfg.logit_softcap > 0:
        x = torch.tanh(x / cfg.logit_softcap) * cfg.logit_softcap
    tt = torch.from_numpy(t).reshape(-1)
    valid = tt != IGNORE
    lse = torch.logsumexp(x, -1)
    tgt = x.gather(-1, tt.clamp_min(0)[:, None])[:, 0]
    n = valid.sum().clamp_min(1)
    ce = torch.where(valid, lse - tgt, 0.0).sum() / n
    zl = torch.where(valid, lse * lse, 0.0).sum() / n
    loss = ce + z * zl
    dh, dw = torch.autograd.grad(loss * G, (th, tw))
    return (float(loss.detach()), float(ce.detach()), float(zl.detach()),
            int(n), dh, dw)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(x):
    if isinstance(x, np.ndarray):
        return x
    return x.detach().float().numpy()


@pytest.mark.parametrize("tie,cap,z,dt", CASES, ids=str)
def test_head_loss_matches_reference_and_formula(tie, cap, z, dt):
    cfg, jcfg = _cfgs(tie, cap, dt)
    h, table, t = _inputs(tie, seed=int(tie) + 2 * int(cap > 0))
    before = kce.cross_entropy.launches
    loss, ce, zl, n, dh, dw = _port(cfg, h, table, t, z)
    assert kce.cross_entropy.launches == before    # the plain version ran
    assert not ce.requires_grad and not zl.requires_grad
    assert dh.dtype == getattr(torch, dt) and dw.dtype == torch.float32
    bf16 = dt == "bfloat16"
    for want, rtol, gtol in (
            (_reference(jcfg, h, table, t, z), 2e-4 if bf16 else 1e-5,
             2e-2 if bf16 else 1e-5),
            (_formula(cfg, h, table, t, z), 1e-5, 1e-2 if bf16 else 1e-5)):
        np.testing.assert_allclose(
            [float(loss.detach()), float(ce), float(zl)], want[:3], rtol=rtol)
        assert int(n) == want[3] == int((t != IGNORE).sum())
        assert _rel(_np(dh), _np(want[4])) <= gtol
        assert _rel(_np(dw), _np(want[5])) <= gtol
        # the wholly ignored first chunk gets no gradient
        assert not dh[:, :CHUNK].any()


@pytest.mark.parametrize("tie", (True, False))
def test_no_grad_call_forms_no_gradient(tie, monkeypatch):
    """Under ``torch.no_grad`` (and with nothing that needs a gradient)
    the loss is the one the training call gives, ``HeadLossFunction``
    never runs and the kernel is asked for no gradient."""
    cfg, _ = _cfgs(tie, 30.0, "float32")
    h, table, t = _inputs(tie, seed=5)
    want = _port(cfg, h, table, t, 1e-4)
    asked = []
    orig = kce.cross_entropy_plain

    def spy(*a, grad=False, **kw):
        asked.append(grad)
        return orig(*a, grad=grad, **kw)
    monkeypatch.setattr(kce, "cross_entropy_plain", spy)
    monkeypatch.setattr(common.HeadLossFunction, "forward",
                        staticmethod(lambda *a: pytest.fail("ran")))
    with torch.no_grad():
        got_ng = _port(cfg, h, table, t, 1e-4, grad=False)
    got_nr = _port(cfg, h, table, t, 1e-4, grad=False)
    for got in (got_ng, got_nr):
        assert not got[0].requires_grad
        for a, b in zip(got[:4], want[:4]):
            assert float(a.detach()) == float(b.detach())
    assert asked and not any(asked)
    assert kce.cross_entropy.launches == 0


def test_plain_kernel_function_matches_formula():
    """``cross_entropy_plain`` over rows of 37 (no multiple of 8) with
    targets below 0 (column 0, as the chain's clamp) and ``ignore_id``
    (-100 here): the outputs and the gradient written
    over the logits against autograd."""
    rng = np.random.default_rng(7)
    R, Vv = 6, 37
    x = torch.from_numpy(rng.standard_normal((R, Vv)).astype(np.float32))
    t = torch.tensor([3, -100, -2, 36, 17, 0])
    n = torch.tensor(4)
    for cap in (0.0, 5.0):
        xr = x.clone().requires_grad_()
        c = torch.tanh(xr / cap) * cap if cap else xr
        lse = torch.logsumexp(c, -1)
        tgt = c.gather(-1, t.clamp_min(0)[:, None])[:, 0]
        valid = t != -100
        nll = torch.where(valid, lse - tgt, 0.0)
        zsq = torch.where(valid, lse * lse, 0.0)
        (g,) = torch.autograd.grad((nll.sum() + 0.3 * zsq.sum()) / n, xr)
        got = x.clone()
        out = kce.cross_entropy_plain(got, t, n, softcap=cap, z_coef=0.3,
                                      ignore_id=-100, grad=True)
        for a, b in zip(out, (lse, nll, zsq)):
            torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got, g, rtol=1e-5, atol=1e-7)
        assert not got[1].any()


def test_fake_tensors_take_the_card_branch():
    """The dry run: under ``FakeTensorMode`` the training call allocates
    one (R, V) buffer in the compute dtype and no f32 (R, V) tensor, adds
    each chunk's ``cross_entropy_work`` to the tally, and gives the plain
    call's shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode
    cfg, _ = _cfgs(True, 0.0, "bfloat16")
    h, table, t = _inputs(True)
    R = B * CHUNK

    class Outputs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    self.seen.append((func, tuple(o.shape), o.dtype))
            return out

    want = _port(cfg, h, table, t, 1e-4)
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(torch.from_numpy(a)) for a in (h, table)]
        th = args[0].to(torch.bfloat16).requires_grad_()
        tw = args[1].requires_grad_()
        with cost.tallying() as tally, Outputs() as rec:
            loss, met = common.chunked_ce_loss(
                cfg, {"embedding": tw}, th,
                mode.from_tensor(torch.from_numpy(t)), chunk=CHUNK,
                z_coef=1e-4, ignore_id=IGNORE)
            dh, dw = torch.autograd.grad(loss, (th, tw))
    assert loss.shape == () and dh.shape == want[4].shape
    assert dw.shape == want[5].shape and dw.dtype == torch.float32
    nc = -(-S // CHUNK)
    assert tally.calls == {"cross_entropy": nc}
    rows = [B * min(CHUNK, S - i) for i in range(0, S, CHUNK)]
    assert tally.nbytes == sum(cost.cross_entropy_work(r, V, 2, True, False)
                               [0] for r in rows)
    wide = [(f, s, d) for f, s, d in rec.seen if len(s) == 2 and s[1] == V]
    assert ((R, V), torch.bfloat16) in [(s, d) for _, s, d in wide]
    assert not [w for w in wide if w[2] == torch.float32], wide
    assert kce.cross_entropy.launches == 0


def test_wrapper_checks_raise_before_building():
    """The card branch's checks, reached here through a meta tensor's
    device (no build, no launch)."""
    lg = torch.empty((4, 10), dtype=torch.bfloat16, device="meta")
    t = torch.zeros(4, dtype=torch.int64, device="meta")
    n = torch.ones((), dtype=torch.int64, device="meta")
    call = kce._cross_entropy_cuda
    kw = dict(softcap=0.0, z_coef=0.0, ignore_id=-1, grad=True)
    with pytest.raises(ValueError, match="float32 or"):
        call(lg.half(), t, n, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.empty((10, 4), dtype=torch.bfloat16, device="meta").t(),
             t, n, **kw)
    with pytest.raises(ValueError, match="int64"):
        call(lg, t.int(), n, **kw)
    with pytest.raises(ValueError, match="one int64"):
        call(lg, t, n.expand(2), **kw)
    with pytest.raises(ValueError, match="softcap"):
        call(lg, t, n, **dict(kw, softcap=-1.0))
    with pytest.raises(ValueError, match="one device"):
        call(lg, torch.zeros(4, dtype=torch.int64), n, **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        kce.cross_entropy(lg, t, n)
