"""The port's checkpoint path: Fletcher-64 (repro_torch.kernels.fletcher),
the named-buffer codecs and manifests (repro_torch.services.base), the
checkpoint and datafeed services (found by name through the port's
fabric registry or the reference's), and ``replicated_call``.

On the CPU: ``fletcher64_plain`` equals ``ref.fletcher64_ref`` and
``ops.fletcher64(impl="xla")`` exactly, so does the batch's plain
version shard by shard on a mixed list, and a manifest of one numpy tree
is identical in both packages (keys, shapes, dtypes, byte counts,
checksums); the server verifies in groups under its byte budget and
names the first bad shard; port-side mirrors of tests/test_services.py's checkpoint,
datafeed and replicated-call tests; a bf16 leaf survives a round trip
bit for bit; and checkpoints cross between the packages over tcp — the
reference's client saves reduced-qwen weights to the port's server, the
port's client restores them and the port's logits equal the reference's
(1e-4, f32 on both sides).  On the card (``-m gpu``): the Fletcher-64
kernel against the plain version, one buffer and a mixed batch (a
flipped byte changes its own shard's checksum only), and a save/restore
through the card, one batch a step.

The card's machine has no JAX, so JAX is imported inside the tests that
hold the port against the reference, not at the top."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.executor import Engine, RemoteError  # noqa: E402
from repro_torch.core.types import MercuryError, Ret  # noqa: E402
from repro_torch.kernels.fletcher import (fletcher64,  # noqa: E402
                                          fletcher64_many,
                                          fletcher64_many_plain,
                                          fletcher64_plain)
from repro_torch.services import base as svc_base  # noqa: E402
from repro_torch.services import checkpoint as ckpt  # noqa: E402
from repro_torch.services import (CheckpointClient,  # noqa: E402
                                  CheckpointServer, DataFeedClient,
                                  DataFeedServer, checksum_of,
                                  flatten_named, manifest_of,
                                  replicated_call, unflatten_named)

LENGTHS = [0, 1, 2047, 2048, 2049]
BYTE_COUNTS = [1, 2, 3, 5, 6, 7, 1001, 4099]


def _words(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                                dtype=np.uint32)


@pytest.fixture(scope="module")
def ref():
    """The reference's Fletcher-64 oracles."""
    pytest.importorskip("jax")
    from repro.kernels import ops
    from repro.kernels import ref as ref_mod
    return ops, ref_mod


@pytest.fixture
def tcp_pair():
    with Engine("tcp://127.0.0.1:0") as a, Engine("tcp://127.0.0.1:0") as b:
        yield a, b


# ---------------------------------------------------------------------------
# Fletcher-64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", LENGTHS + ["random"] * 4)
def test_fletcher_plain_matches_reference(ref, n):
    ops, ref_mod = ref
    rng = np.random.default_rng(7 if n == "random" else n)
    n = int(rng.integers(1, 50_000)) if n == "random" else n
    buf = _words(n, seed=int(rng.integers(1 << 30)))
    want = ref_mod.fletcher64_ref(buf)
    assert ops.fletcher64(buf, impl="xla") == want
    assert fletcher64_plain(buf) == want
    assert fletcher64(torch.from_numpy(buf.view(np.int32))) == want


@pytest.mark.parametrize("nbytes", BYTE_COUNTS)
def test_fletcher_pads_bytes_as_the_reference(nbytes):
    """A byte count that is no multiple of 4 is zero-padded to a word,
    as ``services.base.checksum_of`` does."""
    pytest.importorskip("jax")
    from repro.services.base import checksum_of as jchecksum
    raw = np.random.default_rng(nbytes).integers(0, 256, size=nbytes,
                                                 dtype=np.uint8)
    assert fletcher64_plain(raw) == jchecksum(raw)
    assert checksum_of(torch.from_numpy(raw)) == jchecksum(raw)


def test_fletcher_canonical_residues(ref):
    """Words of 2^32 - 1 are 0 mod M: both sums are 0, not M."""
    ops, _ = ref
    buf = np.full(70_000, 2 ** 32 - 1, np.uint32)
    assert fletcher64_plain(buf) == ops.fletcher64(buf, impl="xla") == 0


@pytest.mark.parametrize("seed", range(8))
def test_fletcher_detects_corruption(seed):
    rng = np.random.default_rng(seed)
    buf = _words(1000, seed=seed)
    want = fletcher64_plain(buf)
    buf2 = buf.copy()
    buf2[int(rng.integers(0, buf.size))] ^= np.uint32(
        1 << int(rng.integers(0, 32)))
    assert fletcher64_plain(buf2) != want


def test_fletcher_dispatch_by_device():
    x = torch.arange(100, dtype=torch.float32)
    before = fletcher64.launches
    assert fletcher64(x) == fletcher64_plain(x.numpy())
    assert fletcher64.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        fletcher64(x.to("meta"))


def _mixed_batch(as_torch, device="cpu"):
    """Shards of every kind a batch meets: empty, 1-3 bytes, 4 KB, a
    view at an odd offset, bf16; with the bytes each one holds.  Torch
    leaves lie on ``device`` (the view is taken there)."""
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, size=1002, dtype=np.uint8)
    bf = rng.standard_normal((33, 17)).astype(np.float32)
    leaves = [np.empty(0, np.uint8), raw[:1], raw[:2], raw[:3],
              rng.integers(0, 2 ** 32, 1024, dtype=np.uint32)]
    want = [x.tobytes() for x in leaves]
    if as_torch:
        leaves = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                   else x).to(device) for x in leaves]
    view = torch.from_numpy(raw).to(device)[1:1002]
    bf16 = torch.from_numpy(bf).to(torch.bfloat16).to(device)
    want += [raw[1:1002].tobytes(),
             bf16.view(torch.int16).cpu().numpy().tobytes()]
    return leaves + [view, bf16], want


def _ref_checksum(ref_mod, data: bytes) -> int:
    buf = np.frombuffer(data + bytes(-len(data) % 4), np.uint32)
    return ref_mod.fletcher64_ref(buf)


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_fletcher_many_plain_matches_reference(ref, as_torch):
    """The batch's plain version, and the batch entry on the CPU, equal
    the reference's oracle shard by shard; the CPU counts no launch."""
    _, ref_mod = ref
    leaves, data = _mixed_batch(as_torch)
    want = [_ref_checksum(ref_mod, d) for d in data]
    before = fletcher64.launches
    assert fletcher64_many_plain(leaves) == want
    assert fletcher64_many(leaves) == want
    assert fletcher64.launches == before


# ---------------------------------------------------------------------------
# manifests and codecs
# ---------------------------------------------------------------------------
def _tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((30, 20)).astype(np.float32),
                       "b": rng.integers(0, 255, 7).astype(np.uint8)},
            "opt": (np.ones(5, np.int64), {"count": np.int32(7)}),
            "layers": [{"z": np.zeros(3, np.float64)},
                       {"z": np.full(3, 2.0)}]}


def test_manifest_is_identical_in_both_packages():
    jax = pytest.importorskip("jax")
    from repro.services import base as jbase
    tree = _tree()
    jnamed = jbase.flatten_named(tree)
    named = flatten_named(tree)
    assert list(named) == list(jnamed)
    assert "['layers'][0]['z']" in named
    assert manifest_of(named) == jbase.manifest_of(jnamed)
    # the same leaves as torch tensors: the same manifest
    tnamed = flatten_named(jax.tree_util.tree_map(torch.from_numpy,
                                                  jax.tree_util.tree_map(
                                                      np.asarray, tree)))
    assert manifest_of(tnamed) == jbase.manifest_of(jnamed)


def test_bf16_manifest_matches_reference():
    pytest.importorskip("jax")
    import ml_dtypes
    from repro.services import base as jbase
    a = np.random.default_rng(1).standard_normal((9, 7)).astype(
        ml_dtypes.bfloat16)
    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    assert manifest_of({"x": t}) == jbase.manifest_of({"x": a})


def test_flatten_unflatten_roundtrip():
    tree = {"a": np.ones((2, 3)), "b": (np.zeros(4), {"c": np.int32(2)})}
    named = flatten_named(tree)
    tpl = {"a": np.zeros((2, 3)), "b": (np.zeros(4), {"c": np.int32(0)})}
    out = unflatten_named(tpl, named)
    assert isinstance(out["b"], tuple)
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"][0], tree["b"][0])
    assert int(out["b"][1]["c"]) == 2


# ---------------------------------------------------------------------------
# mirrors of tests/test_services.py
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tcp_pair):
    srv, cli_e = tcp_pair
    CheckpointServer(srv, device="cpu")
    cli = CheckpointClient(cli_e, srv.uri)
    tree = {"params": {"w": np.arange(60_000, dtype=np.float32).reshape(
        300, 200)}, "opt": (np.ones(5, np.int64), {"count": np.int32(7)})}
    assert cli.save("m", 3, tree)["ok"]
    tpl = {"params": {"w": np.zeros((300, 200), np.float32)},
           "opt": (np.zeros(5, np.int64), {"count": np.int32(0)})}
    out, step = cli.restore("m", tpl, device="cpu")
    assert step == 3
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  tree["params"]["w"])
    np.testing.assert_array_equal(out["opt"][0].numpy(), tree["opt"][0])
    assert int(out["opt"][1]["count"]) == 7


def test_checkpoint_latest_and_list(tcp_pair):
    srv, cli_e = tcp_pair
    CheckpointServer(srv, device="cpu")
    cli = CheckpointClient(cli_e, srv.uri)
    tree = {"x": np.ones(10, np.float32)}
    cli.save("m", 1, tree)
    cli.save("m", 5, {"x": np.full(10, 5.0, np.float32)})
    out, step = cli.restore("m", {"x": np.zeros(10, np.float32)},
                            device="cpu")
    assert step == 5 and float(out["x"][0]) == 5.0
    assert {c["step"] for c in cli.list()} == {1, 5}
    assert cli.delete("m", 1) and {c["step"] for c in cli.list()} == {5}


def test_checkpoint_checksum_detects_corruption(tcp_pair):
    srv, cli_e = tcp_pair
    server = CheckpointServer(srv, device="cpu")
    cli = CheckpointClient(cli_e, srv.uri)
    cli.save("m", 1, {"x": torch.arange(1000, dtype=torch.float32)})
    # corrupt the stored shard behind the server's back
    entry = server.store[("m", 1)]
    list(entry["named"].values())[0][17] = 1e9
    with pytest.raises(MercuryError) as e:
        cli.restore("m", {"x": torch.zeros(1000)}, device="cpu")
    assert e.value.ret == Ret.CHECKSUM_ERROR


def test_server_verifies_in_groups_under_its_byte_budget(tcp_pair,
                                                        monkeypatch):
    """The server copies shards to its device in groups of at most
    ``VERIFY_GROUP_BYTES`` (a larger shard alone), one checksum batch a
    group; save and restore checksum the whole tree in one batch each.
    A bad group names its first bad shard."""
    srv, cli_e = tcp_pair
    CheckpointServer(srv, device="cpu")
    cli = CheckpointClient(cli_e, srv.uri)
    monkeypatch.setattr(ckpt, "VERIFY_GROUP_BYTES", 1000)
    batches = []
    orig = svc_base.fletcher64_many

    def spy(xs):
        batches.append(len(xs))
        return orig(xs)
    monkeypatch.setattr(svc_base, "fletcher64_many", spy)
    sizes = {"a": 100, "b": 100, "c": 100, "d": 500, "e": 25}  # f32 words
    tree = {k: np.arange(n, dtype=np.float32) + i
            for i, (k, n) in enumerate(sizes.items())}
    assert cli.save("g", 1, tree)["ok"]
    # the manifest (5 shards), then the server's groups: 400 + 400 bytes,
    # 400, the 2000-byte shard alone, 100
    assert batches == [5, 2, 1, 1, 1]
    out, _ = cli.restore("g", tree, device="cpu")
    assert batches[-1] == 5
    for k in tree:
        np.testing.assert_array_equal(out[k].numpy(), tree[k])
    # two bad shards in one group: the first is named
    man = svc_base.manifest_of(svc_base.flatten_named(tree))
    host = {k: v.copy() for k, v in svc_base.flatten_named(tree).items()}
    host["['b']"][3] += 1.0
    host["['a']"][7] += 1.0
    with pytest.raises(MercuryError, match=r"shard \['a'\]") as e:
        ckpt._verify_on(torch.device("cpu"), man, host)
    assert e.value.ret == Ret.CHECKSUM_ERROR


def test_checkpoint_restore_missing(tcp_pair):
    srv, cli_e = tcp_pair
    CheckpointServer(srv, device="cpu")
    cli = CheckpointClient(cli_e, srv.uri)
    with pytest.raises(RemoteError):
        cli.restore("ghost", {"x": np.zeros(1)}, device="cpu")


def test_checkpoint_bf16_roundtrip_is_bitwise(tcp_pair):
    """bf16 shards travel as raw uint16 host buffers under the manifest
    dtype "bfloat16"; the restored tensor has the same bits."""
    srv, cli_e = tcp_pair
    server = CheckpointServer(srv, device="cpu")
    cli = CheckpointClient(cli_e, srv.uri)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (33, 17)).astype(np.float32)).to(torch.bfloat16)
    fut = cli.async_save("bf", 2, {"w": x, "n": torch.tensor(3)})
    assert fut.result(timeout=60)["ok"]
    man = server.store[("bf", 2)]["manifest"]
    assert man["dtypes"] == ["int64", "bfloat16"]
    out, _ = cli.restore("bf", {"w": torch.zeros(33, 17, dtype=torch.bfloat16),
                                "n": torch.tensor(0)}, device="cpu")
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), x.view(torch.int16))
    assert int(out["n"]) == 3


_BF16_ALONE = """
import sys
import torch
from repro_torch.core.executor import Engine
from repro_torch.services import CheckpointClient, CheckpointServer
x = torch.arange(40, dtype=torch.float32).to(torch.bfloat16)
with Engine("tcp://127.0.0.1:0") as s, Engine("tcp://127.0.0.1:0") as c:
    CheckpointServer(s, device="cpu")
    cli = CheckpointClient(c, s.uri)
    cli.save("bf", 1, {"w": x})
    out, _ = cli.restore("bf", {"w": torch.zeros_like(x)}, device="cpu")
assert torch.equal(out["w"].view(torch.int16), x.view(torch.int16))
print(sorted(m for m in sys.modules if m.split(".")[0] in ("ml_dtypes", "jax")))
"""


def test_bf16_checkpoint_needs_no_ml_dtypes():
    """The card's machine has no ml_dtypes: a bf16 round trip must not
    lean on it (in this process JAX has registered it with numpy)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", _BF16_ALONE], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_datafeed_eager_vs_bulk_identical():
    from repro.data.pipeline import SyntheticSource
    src = SyntheticSource(vocab=500, seq_len=64, batch_per_host=4)
    with Engine("tcp://127.0.0.1:0") as fe_eager, \
            Engine("tcp://127.0.0.1:0") as fe_bulk, \
            Engine("tcp://127.0.0.1:0") as tr:
        DataFeedServer(fe_eager, src, eager_limit=1 << 30)
        DataFeedServer(fe_bulk, src, eager_limit=1)
        c_eager = DataFeedClient(tr, [fe_eager.uri])
        c_bulk = DataFeedClient(tr, [fe_bulk.uri])
        b1, b2 = c_eager.get(7), c_bulk.get(7)
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k])
            np.testing.assert_array_equal(b1[k], src.batch_at(7)[k])


def test_datafeed_prefetch_pipeline():
    from repro.data.pipeline import SyntheticSource
    src = SyntheticSource(vocab=100, seq_len=32, batch_per_host=2)
    with Engine("tcp://127.0.0.1:0") as fe, Engine("tcp://127.0.0.1:0") as tr:
        DataFeedServer(fe, src)
        cli = DataFeedClient(tr, [fe.uri], depth=3)
        for step in range(6):
            b = cli.get(step)
            np.testing.assert_array_equal(b["tokens"],
                                          src.batch_at(step)["tokens"])


def test_replicated_call_first_wins_over_straggler():
    with Engine("tcp://127.0.0.1:0") as slow, \
            Engine("tcp://127.0.0.1:0") as fast, \
            Engine("tcp://127.0.0.1:0") as cli:
        slow.register("work", lambda x: time.sleep(5.0) or "slow")
        fast.register("work", lambda x: "fast")
        t0 = time.monotonic()
        out = replicated_call(cli, [slow.uri, fast.uri], "work", None,
                              timeout=10.0)
        assert out == "fast"
        assert time.monotonic() - t0 < 3.0


def test_replicated_call_survives_dead_target():
    with Engine("tcp://127.0.0.1:0") as ok, Engine("tcp://127.0.0.1:0") as cli:
        ok.register("work", lambda x: 42)
        out = replicated_call(cli, ["tcp://127.0.0.1:1", ok.uri], "work",
                              None, timeout=5.0)
        assert out == 42


# ---------------------------------------------------------------------------
# devices and what is not ported
# ---------------------------------------------------------------------------
def test_services_do_not_fall_back_to_the_cpu(tcp_pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    srv, cli_e = tcp_pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointServer(srv)
    CheckpointServer(srv, device="cpu")
    cli = CheckpointClient(cli_e, srv.uri)
    cli.save("m", 1, {"x": np.ones(4, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.restore("m", {"x": np.zeros(4, np.float32)})


class _Source:
    def batch_at(self, step):
        return {"tokens": np.full((2, 4), step, np.int32)}


def test_registry_is_not_ported(tcp_pair):
    """Registration is ported (the name is historical): servers given
    ``registry=`` register with the port's RegistryService, clients given
    ``registry=`` resolve them by service name, and ``close()``
    deregisters them."""
    from repro_torch.fabric import RegistryClient, RegistryService
    srv, cli_e = tcp_pair
    with Engine("tcp://127.0.0.1:0") as reg_e:
        reg = RegistryService(reg_e)
        try:
            server = CheckpointServer(srv, registry=reg_e.uri, device="cpu")
            feeder = DataFeedServer(srv, _Source(), registry=reg_e.uri)
            cli = CheckpointClient(cli_e, registry=reg_e.uri)
            feed = DataFeedClient(cli_e, registry=reg_e.uri)
            assert cli.server == srv.uri and feed.feeders == [srv.uri]
            cli.save("m", 1, {"x": np.arange(4, dtype=np.float32)})
            assert [c["step"] for c in cli.list()] == [1]
            assert int(feed.get(3)["tokens"][0, 0]) == 3
            for s in (server, feeder):
                s.close()
            view = RegistryClient(cli_e, reg_e.uri)
            assert view.resolve("ckpt")["instances"] == []
            assert view.resolve("feed")["instances"] == []
            with pytest.raises(MercuryError):
                CheckpointClient(cli_e, registry=reg_e.uri)
        finally:
            reg.close()


@pytest.mark.parametrize("side", ["port", "reference"])
def test_trainer_finds_its_services_by_name(side):
    """A trainer resolves its feeder and its checkpoint server by service
    name, through the port's registry or the reference's (over tcp), then
    trains reduced qwen two steps on the fed batches and saves."""
    from repro_torch import configs
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data.pipeline import SyntheticSource
    from repro_torch.models import Model
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step
    if side == "port":
        from repro_torch.fabric import RegistryService
        reg_engine = Engine("tcp://127.0.0.1:0")
    else:
        pytest.importorskip("jax")
        from repro.core.executor import Engine as JEngine
        from repro.fabric import RegistryService
        reg_engine = JEngine("tcp://127.0.0.1:0")
    cfg = configs.reduced("qwen1.5-0.5b")
    with reg_engine as reg_e, Engine("tcp://127.0.0.1:0") as srv, \
            Engine("tcp://127.0.0.1:0") as trainer:
        reg = RegistryService(reg_e)
        try:
            server = CheckpointServer(srv, registry=reg_e.uri,
                                      service="ckpt-t", device="cpu")
            feeder = DataFeedServer(srv, SyntheticSource(cfg.vocab, 16, 2),
                                    registry=reg_e.uri, service="feed-t")
            feed = DataFeedClient(trainer, registry=reg_e.uri,
                                  service="feed-t")
            cli = CheckpointClient(trainer, registry=reg_e.uri,
                                   service="ckpt-t")
            model = Model(cfg)
            ocfg = optim.OptConfig(lr=1e-3, warmup=0, decay_steps=10)
            state = init_state(model, ocfg, 0, device="cpu")
            step = make_train_step(model, ocfg, ParallelConfig(remat="none"))
            losses = []
            for i in range(2):
                raw = feed.get(i)
                state, met = step(state, {k: torch.tensor(raw[k])
                                          for k in ("tokens", "targets")})
                losses.append(float(met["loss"]))
            cli.save(cfg.name, 2, state)
            assert [c["step"] for c in cli.list()] == [2]
            assert all(np.isfinite(losses))
            server.close()
            feeder.close()
        finally:
            reg.close()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def test_reference_checkpoint_restores_into_the_port():
    """The reference's client saves reduced-qwen JAX weights to the port's
    server over tcp; the port's client restores them into a template of
    the same tree, the bridge carries them into the port's Model, and its
    logits equal the reference's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.executor import Engine as JEngine
    from repro.models import Model as JModel
    from repro.models import unzip
    from repro.services import CheckpointClient as JCheckpointClient
    from repro_torch import configs
    from repro_torch.models import Model, params_from_numpy

    arch = "qwen1.5-0.5b"
    jm = JModel(jconfigs.reduced(arch).replace(compute_dtype="float32"))
    jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    with Engine("tcp://127.0.0.1:0") as srv, \
            JEngine("tcp://127.0.0.1:0") as jcli_e, \
            Engine("tcp://127.0.0.1:0") as cli_e:
        server = CheckpointServer(srv, device="cpu")
        assert JCheckpointClient(jcli_e, srv.uri).save("qwen", 4, jp)["ok"]
        assert server.store[("qwen", 4)]["manifest"]["keys"] == \
            list(flatten_named(jp))
        tpl = jax.tree_util.tree_map(np.zeros_like, jp)
        restored, step = CheckpointClient(cli_e, srv.uri).restore(
            "qwen", tpl, device="cpu")
    assert step == 4
    tm = Model(configs.reduced(arch).replace(compute_dtype="float32"))
    tp = params_from_numpy(restored, device="cpu")
    toks = np.random.default_rng(0).integers(0, 500, (2, 24)).astype(
        np.int32)
    jl, _ = jm.prefill(jax.tree_util.tree_map(jnp.asarray, jp),
                       {"tokens": jnp.asarray(toks)}, cache_len=32,
                       impl="xla")
    tl, _ = tm.prefill(tp, torch.from_numpy(toks), cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_port_checkpoint_restores_through_the_reference():
    """The other way: the port's client saves torch tensors to the
    reference's server; the reference's client restores them bit for
    bit.  (No bf16 leaf: the reference's bulk layer cannot expose an
    ``ml_dtypes`` bf16 buffer, ROADMAP Queue C.)"""
    pytest.importorskip("jax")
    from repro.core.executor import Engine as JEngine
    from repro.services import CheckpointClient as JCheckpointClient
    from repro.services import CheckpointServer as JCheckpointServer
    rng = np.random.default_rng(3)
    w = rng.standard_normal((40, 9)).astype(np.float32)
    n = rng.integers(0, 1 << 30, 5).astype(np.int32)
    tree = {"w": torch.from_numpy(w), "n": torch.from_numpy(n)}
    with JEngine("tcp://127.0.0.1:0") as jsrv, \
            JEngine("tcp://127.0.0.1:0") as jcli_e, \
            Engine("tcp://127.0.0.1:0") as cli_e:
        JCheckpointServer(jsrv)
        assert CheckpointClient(cli_e, jsrv.uri).save("t", 1, tree)["ok"]
        out, _ = JCheckpointClient(jcli_e, jsrv.uri).restore(
            "t", {"w": np.zeros_like(w), "n": np.zeros_like(n)})
    np.testing.assert_array_equal(out["w"], w)
    np.testing.assert_array_equal(out["n"], n)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", LENGTHS + [50_001, 1 << 20, 3_000_017])
def test_fletcher_kernel_matches_plain_on_card(card, n):
    buf = torch.from_numpy(_words(n, seed=n).view(np.int32)).to(card)
    before = fletcher64.launches
    got = fletcher64(buf)
    assert fletcher64.launches == before + 1
    assert got == fletcher64_plain(buf)
    if n:
        flipped = buf.clone()
        flipped[n // 2] ^= 1 << 13
        assert fletcher64(flipped) != got


@pytest.mark.gpu
@pytest.mark.parametrize("nbytes", BYTE_COUNTS + [65_539])
def test_fletcher_kernel_pads_bytes_on_card(card, nbytes):
    raw = torch.from_numpy(np.random.default_rng(nbytes).integers(
        0, 256, size=nbytes + 1, dtype=np.uint8)).to(card)
    assert fletcher64(raw[:nbytes]) == fletcher64_plain(raw[:nbytes].cpu())
    # a view at an odd offset is not 16-byte aligned
    assert fletcher64(raw[1:]) == fletcher64_plain(raw[1:].cpu())


@pytest.mark.gpu
def test_checkpoint_through_the_card(card, tcp_pair):
    """Save card tensors (checksummed there), verify on the server's
    card, restore onto the card bitwise."""
    srv, cli_e = tcp_pair
    CheckpointServer(srv)
    cli = CheckpointClient(cli_e, srv.uri)
    tree = {"a": torch.randn(300, 70, device=card),
            "b": torch.randn(77, device=card).to(torch.bfloat16)}
    before = fletcher64.launches
    cli.save("g", 1, tree)
    out, _ = cli.restore("g", tree)
    assert fletcher64.launches - before == 3      # save, verify, restore
    for k in tree:
        assert out[k].device.type == "cuda"
        assert torch.equal(out[k].view(torch.int16 if k == "b" else
                                       torch.int32),
                           tree[k].view(torch.int16 if k == "b" else
                                        torch.int32))


@pytest.mark.gpu
def test_fletcher_batch_matches_plain_on_card(card):
    """A mixed batch (the CPU test's shards plus 4 MB and 11.5 MB ones)
    is one launch; each checksum equals the plain version's, and a byte
    flipped in one shard changes that shard's checksum only."""
    xs, _ = _mixed_batch(as_torch=True, device=card)
    assert xs[5].data_ptr() % 16                # the view at an odd offset
    xs += [torch.from_numpy(_words(n, seed=n).view(np.int32)).to(card)
           for n in (1 << 20, 2_875_000)]
    want = fletcher64_many_plain([x.cpu() for x in xs])
    before = fletcher64.launches
    got = fletcher64_many(xs)
    assert fletcher64.launches == before + 1
    assert got == want
    for i in (3, 5, len(xs) - 1):
        flipped = list(xs)
        raw = xs[i].clone().reshape(-1).view(torch.uint8)
        raw[raw.numel() // 2] ^= 1 << 6
        flipped[i] = raw
        again = fletcher64_many(flipped)
        assert again[i] != got[i] and again[i] == fletcher64_plain(raw.cpu())
        assert again[:i] + again[i + 1:] == got[:i] + got[i + 1:]
