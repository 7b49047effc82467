"""Expert parallelism: the routing kernel's expert range and the MoE layer
over a mesh (``MoESpmd``), against the reference and the port's
unsharded layer.

The routing's plain version with an expert range [e_start, e_start +
e_local) gives each kept assignment of the range the full dispatch's slot
less e_start·C and every other the sentinel e_local·C, and its src is
the full src's slice; at e_start 0 and e_local E every output is bit for
bit what the dispatch gave before the range existed (a frozen copy of
that code is the yardstick).

The layer runs once per module as 4 gloo ranks on the CPU
(``torch_ranks``, 120 s limit), on meshes (data 2, model 2) and (data 1,
model 4), for reduced granite-moe-3b-a800m and reduced
deepseek-moe-16b (a shared expert), f32:

* dropless (capacity factor 16, as the reference's sharded test; on
  (1, 4) also with no token axes at all): y and
  the aux losses against the reference's ``moe_apply(spmd=None)`` on the
  whole token set (1e-5); the gradients of x, the router, every expert
  and the shared expert against the port's unsharded layer under the
  same objective (1e-5 of each gradient's largest entry);
* at capacity factor 1.25, where shards drop other assignments than the
  whole would: each rank's y against the port's unsharded layer run on
  that rank's tokens alone.

On the card (``-m gpu``): the routing kernel with an expert range against
its plain version, and the combine and its backward over a shard's
slots.  JAX is imported by the ``ref`` fixture, not at the top: the
card's machine has none."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_combine as kc  # noqa: E402
from repro_torch.kernels import moe_router as kr  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b")
MESHES = ((2, 2), (1, 4))
CASES = {f"{a.split('-')[0]}-{m[0]}x{m[1]}-{mode}": (a, m, cf, ("data",))
         for a in ARCHS for m in MESHES
         for mode, cf in (("dropless", 16.0), ("cf1.25", 1.25))}
# every rank holds every token: no token axes to sum the aux over, and
# their gradient still counts once across the expert shards
CASES.update({f"{a.split('-')[0]}-1x4-notok-dropless": (a, (1, 4), 16.0, ())
              for a in ARCHS})
DROPLESS = sorted(n for n in CASES if n.endswith("dropless"))
DROPPING = sorted(n for n in CASES if n.endswith("cf1.25"))
B, S = 4, 8
TOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("jax")


# ---------------------------------------------------------------------------
# the routing's expert range, plain version
# ---------------------------------------------------------------------------
def _logits(T, E, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (T, E)).astype(np.float32))


def _dispatch_before(idx, n_experts, capacity, dispatch="sort"):
    """``dispatch_plain`` as it was before the expert range: the
    yardstick for e_start 0, e_local E."""
    T, k = idx.shape
    n = T * k
    flat_e = idx.reshape(-1).long()
    experts = torch.arange(n_experts)
    onehot = flat_e[:, None] == experts[None, :]
    if dispatch == "cumsum":
        ohf = onehot.float()
        prior = torch.cumsum(ohf, dim=0) - ohf
        pos = (prior * ohf).sum(1).long()
    else:
        order = torch.argsort(flat_e, stable=True)
        se = flat_e[order]
        seg_start = torch.searchsorted(se, experts)
        pos = torch.empty_like(order).scatter_(
            0, order, torch.arange(n) - seg_start[se])
    n_slots = n_experts * capacity
    slot = torch.where(pos < capacity, flat_e * capacity + pos, n_slots)
    src = torch.full((n_slots + 1,), T, dtype=torch.long)
    src.scatter_(0, slot, torch.arange(n) // k)
    return (slot.view(T, k).to(torch.int32), src[:n_slots].to(torch.int32),
            onehot.sum(0).float())


ROUTES = [(T, E, k, C) for (T, E, k) in [(32, 8, 2), (64, 40, 8),
                                         (100, 64, 6), (7, 16, 4)]
          for C in (T, max(T * k // E, 1))]


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("T,E,k,C", ROUTES, ids=str)
def test_full_range_is_the_dispatch_before(T, E, k, C, dispatch):
    x = _logits(T, E, seed=T + E)
    r = kr.router_dispatch(x, k, n_real=E, capacity=C, dispatch=dispatch,
                           e_start=0, e_local=E)
    r0 = kr.router_dispatch(x, k, n_real=E, capacity=C, dispatch=dispatch)
    for a, b in zip(r, r0):
        assert torch.equal(a, b)
    for a, b in zip((r.slot, r.src, r.load),
                    _dispatch_before(r.idx, E, C, dispatch)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("T,E,k,C", ROUTES, ids=str)
def test_expert_range_keeps_the_shards_assignments(T, E, k, C, n_shards):
    """Each shard's slots are the full dispatch's for its experts, less
    e_start·C; the rest get e_local·C; src is the full src's slice; the
    routing and the aux sums are the full call's."""
    x = _logits(T, E, seed=T * E)
    full = kr.router_dispatch(x, k, n_real=E, capacity=C)
    e_local = E // n_shards
    kept = 0
    for i in range(n_shards):
        s = i * e_local
        r = kr.router_dispatch(x, k, n_real=E, capacity=C, e_start=s,
                               e_local=e_local)
        for name in ("w", "idx", "probs", "load", "prob_sum", "z_sum"):
            assert torch.equal(getattr(r, name), getattr(full, name))
        mine = (full.idx >= s) & (full.idx < s + e_local) \
            & (full.slot < E * C)
        want = torch.where(mine, full.slot - s * C, e_local * C)
        assert torch.equal(r.slot, want.to(torch.int32))
        assert torch.equal(r.src, full.src[s * C:(s + e_local) * C])
        kept += int(mine.sum())
    assert kept == int((full.slot < E * C).sum())


# ---------------------------------------------------------------------------
# the MoE layer on a mesh
# ---------------------------------------------------------------------------
def _ref_params(ref, arch):
    from repro import configs as rconfigs
    from repro.models import moe as rmoe
    from repro.models.common import unzip
    cfg = rconfigs.reduced(arch).replace(compute_dtype="float32")
    p, _ = unzip(rmoe.moe_params(cfg, ref.random.PRNGKey(1), ("moe",)))
    return cfg, ref.tree_util.tree_map(np.asarray, p)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def run(ref):
    rng = np.random.default_rng(0)
    params, cases = {}, {}
    for name, (arch, mesh, cf, token_axes) in CASES.items():
        if arch not in params:
            params[arch] = _ref_params(ref, arch)
        cfg, p = params[arch]
        cases[name] = dict(
            arch=arch, mesh=mesh, cf=cf, params=p, token_axes=token_axes,
            x=rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            gy=rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    ranks = run_ranks("torch_dist_scenarios", "moe_layer", 4,
                      {"meshes": MESHES, "cases": cases})
    return params, cases, ranks


def _port_layer(arch, p, x, gy, cf):
    """The port's unsharded layer, its y, aux and the gradients of the
    objective Σ y·gy + moe_lb + moe_z."""
    from repro_torch import configs
    from repro_torch.models.moe import moe_apply
    cfg = configs.reduced(arch).replace(compute_dtype="float32")
    params = _torch_tree(p)
    for t in [v for v in params.values() if not isinstance(v, dict)] + \
            list(params.get("shared", {}).values()):
        t.requires_grad_()
    x = torch.from_numpy(x).requires_grad_()
    y, aux = moe_apply(cfg, params, x, capacity_factor=cf)
    ((y * torch.from_numpy(gy)).sum() + aux["moe_lb"]
     + aux["moe_z"]).backward()
    grads = {k: (v.grad.numpy() if not isinstance(v, dict) else
                 {kk: vv.grad.numpy() for kk, vv in v.items()})
             for k, v in params.items()}
    return y.detach().numpy(), aux, x.grad.numpy(), grads


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _by_shard(ranks, name):
    """{(token shard, expert shard): results} of one case."""
    return {(r[name]["tok"], r[name]["ex"]): r[name] for r in ranks}


@pytest.mark.parametrize("name", DROPLESS)
def test_y_and_aux_match_reference(run, ref, name):
    from repro.models import moe as rmoe
    params, cases, ranks = run
    case = cases[name]
    cfg, p = params[case["arch"]]
    want_y, want_aux = rmoe.moe_apply(cfg, p, case["x"],
                                      capacity_factor=case["cf"])
    shards = _by_shard(ranks, name)
    n_tok, n_ex = case["mesh"]
    b = B // n_tok
    for (t, e), res in shards.items():
        np.testing.assert_allclose(res["y"],
                                   np.asarray(want_y)[t * b:(t + 1) * b],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res["lb"], float(want_aux["moe_lb"]),
                                   rtol=TOL)
        np.testing.assert_allclose(res["z"], float(want_aux["moe_z"]),
                                   rtol=TOL)


@pytest.mark.parametrize("name", DROPLESS)
def test_grads_match_unsharded_layer(run, name):
    params, cases, ranks = run
    case = cases[name]
    _, p = params[case["arch"]]
    _, _, want_dx, want = _port_layer(case["arch"], p, case["x"],
                                      case["gy"], case["cf"])
    shards = _by_shard(ranks, name)
    n_tok, n_ex = case["mesh"]
    b = B // n_tok
    for (t, e), res in shards.items():
        # each token shard's term was scaled by n_tok, as the step's mean
        _close(res["dx"] / n_tok, want_dx[t * b:(t + 1) * b], "dx")

    def mean_over_tokens(get, e):
        return sum(get(shards[(t, e)]) for t in range(n_tok)) / n_tok
    for e in range(n_ex):
        _close(mean_over_tokens(lambda r: r["grads"]["router"], e),
               want["router"], "router")
        for key in ("wi_gate", "wi_up", "wo"):
            n = want[key].shape[0] // n_ex
            _close(mean_over_tokens(lambda r: r["grads"][key], e),
                   want[key][e * n:(e + 1) * n], key)
        for key in want.get("shared", {}):
            _close(mean_over_tokens(lambda r: r["grads"]["shared"][key], e),
                   want["shared"][key], f"shared/{key}")


@pytest.mark.parametrize("name", DROPPING)
def test_dropping_shard_is_the_layer_on_its_tokens(run, name):
    params, cases, ranks = run
    case = cases[name]
    _, p = params[case["arch"]]
    n_tok, _ = case["mesh"]
    b = B // n_tok
    for (t, e), res in _by_shard(ranks, name).items():
        rows = slice(t * b, (t + 1) * b)
        y, _, _, _ = _port_layer(case["arch"], p, case["x"][rows],
                                 case["gy"][rows], case["cf"])
        np.testing.assert_allclose(res["y"], y, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,n_shards,cf", [
    (1024, 40, 8, 2, 1.25), (64, 40, 8, 4, None), (4, 40, 8, 2, None),
    (300, 64, 6, 4, 1.25), (77, 48, 8, 2, 0.5)], ids=str)
def test_kernel_expert_range_matches_plain_on_card(card, T, E, k, n_shards,
                                                   cf):
    C = T if cf is None else max(int(np.ceil(T * k / E * cf)), 1)
    x = _logits(T, E, seed=T).to(card)
    e_local = E // n_shards
    for i in range(n_shards):
        kw = dict(n_real=E, capacity=C, e_start=i * e_local,
                  e_local=e_local)
        before = kr.router_dispatch.launches
        r = kr.router_dispatch(x, k, **kw)
        torch.cuda.synchronize()
        assert kr.router_dispatch.launches == before + 1
        assert r.src.shape == (e_local * C,)
        for dispatch in ("sort", "cumsum"):
            slot, src, load = kr.dispatch_plain(r.idx, E, C, dispatch,
                                                i * e_local, e_local)
            assert torch.equal(r.slot, slot) and torch.equal(r.src, src)
            assert torch.equal(r.load, load)
        p = kr.router_dispatch_plain(x, k, **kw)
        torch.testing.assert_close(r.probs, p.probs, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_over_a_shards_slots_on_card(card, dtype):
    """The combine and its backward over one expert shard's e_local·C
    slots: a choice outside the shard reads as dropped."""
    T, E, k, d, n_shards = 256, 40, 8, 96, 2
    C = int(np.ceil(T * k / E * 1.25))
    e_local = E // n_shards
    x = _logits(T, E, seed=5).to(card)
    r = kr.router_dispatch(x, k, n_real=E, capacity=C, e_start=e_local,
                           e_local=e_local)
    gen = torch.Generator(device=card).manual_seed(0)
    out_buf = torch.randn((e_local * C, d), generator=gen, device=card,
                          dtype=torch.float32).to(dtype)
    dy = torch.randn((T, d), generator=gen, device=card).to(dtype)
    y = kc.moe_combine(out_buf, r.w, r.slot)
    want = kc.moe_combine_plain(out_buf, r.w, r.slot)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    scale = float(want.float().abs().max())
    assert float((y.float() - want.float()).abs().max()) <= tol * scale
    got = kc.moe_combine_bwd(dy, out_buf, x, r.probs, r.idx, r.w, r.slot,
                             r.src, r.prob_sum * 0 + 1e-3, r.z_sum * 0 + 1e-3,
                             n_real=E)
    plain = kc.moe_combine_bwd_plain(dy, out_buf, x, r.probs, r.idx, r.w,
                                     r.slot, r.src, r.prob_sum * 0 + 1e-3,
                                     r.z_sum * 0 + 1e-3, n_real=E)
    for a, b in zip(got, plain):
        s = max(float(b.float().abs().max()), 1e-30)
        assert float((a.float() - b.float()).abs().max()) <= tol * s
