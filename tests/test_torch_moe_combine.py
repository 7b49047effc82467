"""The MoE combine and its backward in the port
(repro_torch.kernels.moe_combine, repro_torch.models.moe).

On the CPU, with seeded numpy inputs: ``moe_combine_plain`` against the
eager formula the MoE layer used before (a zero row concatenated, an
``index_select`` of the T·k rows, a multiply by w and a sum over the
choices), in f32, dropless, at capacity factors 1.25 and 0.5 and with 48
experts of which 40 are real, under both dispatch forms;
``moe_combine_bwd_plain``'s experts' gradient and logits' gradient
against autograd through that formula and ``RouterFunction`` (1e-6 of
each gradient's largest entry: f32 on both sides, the same products
summed in another order); the MoE layer through ``CombineFunction``
against ``jax.grad`` of the reference's ``moe_apply``; empty and padded
slot rows getting a zero gradient and a dropped choice a zero dw; None
for the aux sums' gradients; bitwise repeats; the wrappers' device and
input checks, made before anything is built.  On the card (``-m gpu``):
each kernel against its plain version at granite-moe-3b-a800m's shapes,
f32 within 1e-5 and bf16 within 2e-2 of the largest entry, launches
counted, repeats bitwise, and the MoE layer's training launching
``moe_combine_bwd`` and not ``router_bwd``.

The card's machine has no JAX, so JAX is imported inside the tests that
use it."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.kernels import moe_combine as kc  # noqa: E402
from repro_torch.kernels import moe_router as kr  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# name, T, E, k, n_real, capacity factor (None: dropless, C = T), d
CASES = [
    ("dropless", 24, 8, 2, 8, None, 32),
    ("cf1.25", 24, 8, 2, 8, 1.25, 32),
    ("tight0.5", 24, 8, 2, 8, 0.5, 32),
    ("padded-E48-real40", 64, 48, 8, 40, 1.25, 32),
]
BWD_TOL = 1e-6


def _capacity(T, k, n_real, cf):
    return T if cf is None else max(int(math.ceil(T * k / n_real * cf)), 1)


def _inputs(case, seed=0, device="cpu", dtype=torch.float32):
    """(logits, out_buf, dy, dprob_sum, dz_sum, capacity) from numpy."""
    _, T, E, k, n_real, cf, d = case
    C = _capacity(T, k, n_real, cf)
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((T, E)), rng.standard_normal((E * C, d)),
              rng.standard_normal((T, d)), rng.standard_normal(E),
              np.asarray(rng.standard_normal()))
    logits, out_buf, dy, dps, dz = (
        torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)
    return logits, out_buf.to(dtype), dy.to(dtype), dps, dz, C


def _route(logits, case, C, dispatch="sort"):
    _, _, _, k, n_real, _, _ = case
    return kr.router_dispatch(logits, k, n_real=n_real, capacity=C,
                              dispatch=dispatch)


def eager_combine(out_buf, w, slot):
    """The combine as the MoE layer computed it before: a zero row for
    the dropped choices, the T·k rows gathered, weighted and summed."""
    T, k = slot.shape
    padded = torch.cat([out_buf, out_buf.new_zeros((1, out_buf.shape[1]))])
    vals = padded.index_select(0, slot.reshape(-1).long()).view(T, k, -1)
    return (vals * w[..., None].to(vals.dtype)).sum(1)


def _scaled_err(got, want):
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_combine_matches_eager_formula(case, dispatch):
    logits, out_buf, _, _, _, C = _inputs(case)
    r = _route(logits, case, C, dispatch)
    got = kc.moe_combine_plain(out_buf, r.w, r.slot)
    want = eager_combine(out_buf, r.w, r.slot)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _scaled_err(got, want) <= 1e-6
    if case[0] == "tight0.5":
        assert (r.slot == r.src.shape[0]).any()     # the case drops


def _autograd_chain(logits, out_buf, dy, dps, dz, case, C, dispatch="sort"):
    """The logits' and experts' gradients by autograd through the eager
    formula and ``RouterFunction`` (the layer's graph before)."""
    x = logits.clone().requires_grad_()
    ob = out_buf.clone().requires_grad_()
    r = _route(x, case, C, dispatch)
    assert type(r.w.grad_fn).__name__ == "RouterFunctionBackward"
    y = eager_combine(ob, r.w, r.slot)
    loss = (y * dy).sum() + (r.prob_sum * dps).sum() + r.z_sum * dz
    gx, gob = torch.autograd.grad(loss, (x, ob))
    return gob, gx


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_autograd(case, dispatch):
    logits, out_buf, dy, dps, dz, C = _inputs(case, seed=1)
    want_dout, want_dlogits = _autograd_chain(logits, out_buf, dy, dps, dz,
                                              case, C, dispatch)
    r = _route(logits, case, C, dispatch)
    d_out, dlogits = kc.moe_combine_bwd_plain(
        dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src, dps, dz,
        n_real=case[4])
    assert d_out.dtype == out_buf.dtype and d_out.shape == out_buf.shape
    assert _scaled_err(d_out, want_dout) <= BWD_TOL
    assert _scaled_err(dlogits, want_dlogits) <= BWD_TOL


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_empty_slots_and_dropped_choices_take_no_gradient(case):
    """A slot row whose src is T (empty, or a padded expert's) gets 0;
    a dropped choice's dw is 0: the logits' gradient is
    ``router_bwd_plain``'s with dw summed by hand over the kept choices
    alone."""
    _, T, E, k, n_real, _, _ = case
    logits, out_buf, dy, dps, dz, C = _inputs(case, seed=2)
    r = _route(logits, case, C)
    d_out, dlogits = kc.moe_combine_bwd_plain(
        dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src, dps, dz,
        n_real=n_real)
    empty = r.src == T
    # every case has empty slots or dropped choices (tight0.5 fills each
    # of its 24 slots and drops half of its 48 choices)
    assert empty.any() or (r.slot == E * C).any()
    assert not d_out[empty].any()
    if n_real < E:
        assert not d_out.view(E, C, -1)[n_real:].any()
    dw = torch.zeros(T, k)
    for t in range(T):
        for j in range(k):
            s = int(r.slot[t, j])
            if s < E * C:
                dw[t, j] = (dy[t] * out_buf[s]).sum()
    want = kr.router_bwd_plain(logits, r.probs, r.idx, r.w, dw, dps, dz,
                               n_real=n_real)
    assert _scaled_err(dlogits, want) <= BWD_TOL


def test_missing_aux_gradients_read_as_zero():
    case = CASES[1]
    logits, out_buf, dy, _, _, C = _inputs(case, seed=3)
    r = _route(logits, case, C)
    args = (dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src)
    got = kc.moe_combine_bwd_plain(*args, None, None, n_real=case[4])
    want = kc.moe_combine_bwd_plain(*args, torch.zeros(case[2]),
                                    torch.zeros(()), n_real=case[4])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_plain_versions_repeat_bitwise():
    case = CASES[3]
    logits, out_buf, dy, dps, dz, C = _inputs(case, seed=4)
    r = _route(logits, case, C)
    args = (dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src, dps,
            dz)
    assert torch.equal(kc.moe_combine(out_buf, r.w, r.slot),
                       kc.moe_combine(out_buf, r.w, r.slot))
    for a, b in zip(kc.moe_combine_bwd(*args, n_real=case[4]),
                    kc.moe_combine_bwd(*args, n_real=case[4])):
        assert torch.equal(a, b)


def test_bf16_plain_rounds_once():
    """In bf16 the plain combine sums in f32 and rounds once: it equals
    the f32 formula on the same bf16 rows, rounded to bf16."""
    case = CASES[3]
    logits, out_buf, dy, dps, dz, C = _inputs(case, seed=5,
                                              dtype=torch.bfloat16)
    r = _route(logits, case, C)
    got = kc.moe_combine_plain(out_buf, r.w, r.slot)
    assert got.dtype == torch.bfloat16
    want = eager_combine(out_buf.float(), r.w, r.slot).to(torch.bfloat16)
    assert torch.equal(got, want)
    d_out, _ = kc.moe_combine_bwd_plain(dy, out_buf, logits, r.probs, r.idx,
                                        r.w, r.slot, r.src, dps, dz,
                                        n_real=case[4])
    kept = r.slot[r.slot < r.src.shape[0]].long()
    t = r.src.long()[kept]
    j = (r.slot.long()[t] == kept[:, None]).int().argmax(1)
    want_rows = (r.w[t, j][:, None] * dy.float()[t]).to(torch.bfloat16)
    assert torch.equal(d_out[kept], want_rows)


def test_wrappers_check_before_building():
    """A device with no kernel raises, and the card's launches validate
    their inputs before they build or bind anything (so the checks run
    here, on CPU tensors)."""
    case = CASES[1]
    logits, out_buf, dy, dps, dz, C = _inputs(case)
    r = _route(logits, case, C)
    meta = [t.to("meta") for t in (out_buf, r.w, r.slot)]
    with pytest.raises(ValueError, match="no kernel for device"):
        kc.moe_combine(*meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        kc.moe_combine_bwd(dy.to("meta"), meta[0], logits, r.probs, r.idx,
                           r.w, r.slot, r.src, dps, dz, n_real=case[4])
    built = (kc._fn, kc._bwd_fn)
    with pytest.raises(ValueError, match="int32"):
        kc._moe_combine_cuda(out_buf, r.w, r.slot.long())
    with pytest.raises(ValueError, match="float32 or"):
        kc._moe_combine_cuda(out_buf.double(), r.w, r.slot)
    with pytest.raises(ValueError, match="dy"):
        kc._moe_combine_bwd_cuda(dy[:-1], out_buf, logits, r.probs, r.idx,
                                 r.w, r.slot, r.src, dps, dz,
                                 n_real=case[4])
    with pytest.raises(ValueError, match="src"):
        kc._moe_combine_bwd_cuda(dy, out_buf, logits, r.probs, r.idx, r.w,
                                 r.slot, r.src[:-1], dps, dz,
                                 n_real=case[4])
    with pytest.raises(ValueError, match="n_real"):
        kc._moe_combine_bwd_cuda(dy, out_buf, logits, r.probs, r.idx, r.w,
                                 r.slot, r.src, dps, dz, n_real=0)
    assert (kc._fn, kc._bwd_fn) == built
    assert kc.moe_combine.launches == kc.moe_combine_bwd.launches == 0


# ---------------------------------------------------------------------------
# the MoE layer through CombineFunction
# ---------------------------------------------------------------------------
def _cfgs(E=8, k=2, dispatch="sort"):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import MoEConfig as JMoEConfig
    kw = dict(d_model=32, d_ff=16, vocab=64, compute_dtype="float32")
    return (JModelConfig(moe=JMoEConfig(num_experts=E, top_k=k,
                                        dispatch=dispatch), **kw),
            ModelConfig(moe=MoEConfig(num_experts=E, top_k=k,
                                      dispatch=dispatch), **kw))


class _Spy:
    """``CombineFunction`` with its calls counted."""
    calls = 0

    @classmethod
    def apply(cls, *a):
        cls.calls += 1
        return kc.CombineFunction.apply(*a)


def _layer_grads(cfg, params, x, dy, **kw):
    tp = {k: v.clone().requires_grad_() for k, v in params.items()}
    tx = x.clone().requires_grad_()
    y, aux = moe.moe_apply(cfg, tp, tx, **kw)
    loss = (y * dy).sum() + aux["moe_lb"] + aux["moe_z"]
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tx] + [tp[n] for n in names])
    return y.detach(), dict(zip(["x"] + names, grads))


# mode: (layer keywords, experts E, of which real, dispatch)
LAYER_MODES = {
    "cf1.25": (dict(capacity_factor=1.25), 8, 8, "sort"),
    "tight0.5-cumsum": (dict(capacity_factor=0.5), 8, 8, "cumsum"),
    "dropless": (dict(dropless=True), 8, 8, "sort"),
    "padded-E8-real5": (dict(capacity_factor=1.25), 8, 5, "sort"),
}


@pytest.mark.parametrize("mode", sorted(LAYER_MODES))
def test_layer_gradients_through_combine_match_reference(mode,
                                                         monkeypatch):
    """y and the gradients of x, the router and the experts' weights
    against jax.grad of the reference's moe_apply, with the combine's
    backward carrying the router's gradient.  1e-4 of each gradient's
    largest entry, as tests/test_torch_router_bwd.py holds the layer: f32
    on both sides, but the expert products, the scatter-add and the
    softmax's backward sum in other orders, and the router's gradient is
    a difference of such sums."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models import moe as jmoe
    from repro.models.common import unzip
    kw, e_pad, E, dispatch = LAYER_MODES[mode]
    jcfg, cfg = _cfgs(E=E, dispatch=dispatch)
    jp, _ = unzip(jmoe.moe_params(jcfg, jax.random.PRNGKey(0), ("moe",),
                                  e_pad=e_pad))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    dy = rng.standard_normal((2, 20, 32)).astype(np.float32)

    def f(p, xx):
        y, aux = jmoe.moe_apply(jcfg, p, xx, **kw)
        return (y * dy).sum() + aux["moe_lb"] + aux["moe_z"], y
    (_, jy), (jg, jgx) = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(jp, jnp.asarray(x))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    monkeypatch.setattr(moe, "CombineFunction", _Spy)
    _Spy.calls = 0
    y, got = _layer_grads(cfg, params, torch.from_numpy(x),
                          torch.from_numpy(dy), **kw)
    assert _Spy.calls == 1
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    want = {"x": jgx, **jg}
    for name, g in got.items():
        w = torch.from_numpy(np.array(want[name]))
        assert _scaled_err(g, w) <= 1e-4, name


def test_layer_without_gradient_calls_the_combine_alone(monkeypatch):
    """Serving (no gradient): ``moe_combine`` directly, no autograd
    Function; the same y as with a gradient."""
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_params(cfg, gen)
    x = torch.randn(2, 16, 32, generator=gen)
    monkeypatch.setattr(moe, "CombineFunction", _Spy)
    _Spy.calls = 0
    with torch.no_grad():
        y0, _ = moe.moe_apply(cfg, params, x)
    assert _Spy.calls == 0 and y0.grad_fn is None
    y1, _ = _layer_grads(cfg, params, x, torch.ones_like(x))
    assert _Spy.calls == 1
    assert torch.equal(y0, y1)


def test_layer_backward_repeats_bitwise():
    _, cfg = _cfgs(E=8, k=4)
    gen = torch.Generator().manual_seed(1)
    params = moe.moe_params(cfg, gen)
    x = torch.randn(2, 32, 32, generator=gen)
    dy = torch.randn(2, 32, 32, generator=gen)
    runs = [_layer_grads(cfg, params, x, dy, capacity_factor=0.5)[1]
            for _ in range(2)]
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


# name, T, E, k, n_real, capacity factor (None: dropless), d: granite's
# training shape (T 1024, C 256), decode and a chunk dropless, a chunk
# that drops (C 13), padded experts, rows off 16 bytes
CARD_CASES = [
    ("granite-T1024-C256", 1024, 40, 8, 40, 1.25, 1536),
    ("granite-T4-dropless", 4, 40, 8, 40, None, 1536),
    ("granite-T64-dropless", 64, 40, 8, 40, None, 1536),
    ("granite-T64-C13", 64, 40, 8, 40, 1.0, 1536),
    ("granite-T64-E48-real40", 64, 48, 8, 40, 1.25, 1536),
    ("d90", 64, 40, 8, 40, 1.25, 90),
    ("d66", 64, 40, 8, 40, 1.25, 66),
]
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _card_case(case, dtype, seed=0, offset=0):
    """The case's inputs on the card, routed by the kernel; ``offset``
    moves out_buf's and dy's first element off 16 bytes."""
    logits, out_buf, dy, dps, dz, C = _inputs(case, seed=seed,
                                              device="cuda", dtype=dtype)
    if offset:
        def shifted(t):
            flat = torch.empty(t.numel() + offset, dtype=t.dtype,
                               device=t.device)
            out = flat[offset:].view(t.shape)
            out.copy_(t)
            return out
        out_buf, dy = shifted(out_buf), shifted(dy)
    return logits, out_buf, dy, dps, dz, C, _route(logits, case, C)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[0])
def test_combine_kernel_matches_plain_on_card(case, dtype):
    _card()
    _, out_buf, _, _, _, C, r = _card_case(case, dtype)
    before = kc.moe_combine.launches
    got = kc.moe_combine(out_buf, r.w, r.slot)
    again = kc.moe_combine(out_buf, r.w, r.slot)
    torch.cuda.synchronize()
    assert kc.moe_combine.launches == before + 2
    want = kc.moe_combine_plain(out_buf, r.w, r.slot)
    assert got.dtype == dtype
    assert _scaled_err(got.float(), want.float()) <= CARD_TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[0])
def test_combine_bwd_kernel_matches_plain_on_card(case, dtype):
    _card()
    logits, out_buf, dy, dps, dz, C, r = _card_case(case, dtype, seed=1)
    args = (dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src, dps,
            dz)
    before = kc.moe_combine_bwd.launches
    got = kc.moe_combine_bwd(*args, n_real=case[4])
    again = kc.moe_combine_bwd(*args, n_real=case[4])
    torch.cuda.synchronize()
    assert kc.moe_combine_bwd.launches == before + 2
    want = kc.moe_combine_bwd_plain(*args, n_real=case[4])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert _scaled_err(g.float(), w.float()) <= CARD_TOL[dtype]
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert not got[0][r.src == case[1]].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernels_take_rows_off_16_bytes_on_card(dtype):
    """out_buf and dy starting one element past a 16-byte boundary: the
    element-load path."""
    _card()
    case = CARD_CASES[3]
    logits, out_buf, dy, dps, dz, C, r = _card_case(case, dtype, seed=2,
                                                    offset=1)
    assert out_buf.data_ptr() % 16 != 0
    got = kc.moe_combine(out_buf, r.w, r.slot)
    want = kc.moe_combine_plain(out_buf, r.w, r.slot)
    assert _scaled_err(got.float(), want.float()) <= CARD_TOL[dtype]
    args = (dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src, dps,
            dz)
    for g, w in zip(kc.moe_combine_bwd(*args, n_real=case[4]),
                    kc.moe_combine_bwd_plain(*args, n_real=case[4])):
        assert _scaled_err(g.float(), w.float()) <= CARD_TOL[dtype]


@pytest.mark.gpu
def test_missing_aux_gradients_on_card():
    _card()
    case = CARD_CASES[0]
    logits, out_buf, dy, _, _, C, r = _card_case(case, torch.bfloat16)
    args = (dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src)
    got = kc.moe_combine_bwd(*args, None, None, n_real=case[4])
    want = kc.moe_combine_bwd_plain(*args, None, None, n_real=case[4])
    for g, w in zip(got, want):
        assert _scaled_err(g.float(), w.float()) <= CARD_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_layer_training_launches_the_combine_backward_on_card():
    """The MoE layer in training: the router forward, the combine forward
    and the combine backward once each, ``router_bwd`` never; the
    gradients within 1e-4 of autograd through the plain versions on the
    CPU."""
    _card()
    cfg = ModelConfig(d_model=64, d_ff=32, vocab=64, compute_dtype="float32",
                      moe=MoEConfig(num_experts=8, top_k=2))
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_params(cfg, gen)
    x = torch.randn(2, 32, 64, generator=gen)
    dy = torch.randn(2, 32, 64, generator=gen)
    counters = (kr.router_dispatch, kc.moe_combine, kc.moe_combine_bwd,
                kr.router_bwd)
    before = [f.launches for f in counters]
    y, got = _layer_grads(cfg, {k: v.cuda() for k, v in params.items()},
                          x.cuda(), dy.cuda())
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 0]
    want_y, want = _layer_grads(cfg, params, x, dy)
    assert _scaled_err(y.cpu(), want_y) <= 1e-5
    for name, g in got.items():
        assert _scaled_err(g.cpu(), want[name]) <= 1e-4, name
