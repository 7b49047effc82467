"""The port's fabric under its serving gateway.

The framework-free modules (eight of ``fabric/``, ``services/
membership.py``, ``launch/registry.py`` and ``analysis/lockdep.py``) are
copies of the reference's: each file equals its counterpart once
``repro_torch`` reads ``repro``, but for the lines named in
``MAY_DIFFER``, which holds them to what the reference's tests check.
Then port-side mirrors of the reference's gateway, membership and
affinity tests; the launchers' registry flags; multi-turn conversations
routed through registry, pool, affinity and two gateways, whose tokens
equal the reference's on the same weights (f32); and the wire crossing
packages (a port gateway in a reference registry, called through a
reference pool)."""
import difflib
import os
import queue
import re
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import poll_until  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import unzip  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.executor import Engine, RemoteError  # noqa: E402
from repro_torch.core.types import Ret  # noqa: E402
from repro_torch.fabric import (RegistryClient, RegistryService,  # noqa: E402
                                RetryPolicy, ServicePool, SessionAffinity,
                                ShardedRegistryClient)
from repro_torch.fabric.balancer import prefer_instance  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.services import (MembershipClient,  # noqa: E402
                                  MembershipServer, ServingGateway)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen1.5-0.5b"
CFG = configs.reduced(ARCH).replace(compute_dtype="float32")

COPIES = ["fabric/policy.py", "fabric/balancer.py", "fabric/flow.py",
          "fabric/replication.py", "fabric/sharding.py",
          "fabric/registry.py", "fabric/pool.py", "fabric/affinity.py",
          "services/membership.py", "launch/registry.py",
          "analysis/lockdep.py", "data/pipeline.py"]
# The lines (1-based; in the port's file, in the reference's) where a copy
# may differ once ``repro_torch`` reads ``repro``: the docstring's first
# line; in lockdep also its docstring's opening paragraph (how the port's
# copy is installed) and install()'s signature, wrapped for the longer
# default prefix.
MAY_DIFFER = {"analysis/lockdep.py": ({*range(1, 8), 391, 392},
                                      {*range(1, 5), 388})}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_the_reference(rel):
    port = (ROOT / "src" / "repro_torch" / rel).read_text()
    ref = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    assert "import jax" not in port and "from repro." not in port
    port = re.sub(r"\brepro_torch\b", "repro", port).splitlines()
    assert port[0].startswith('"""') and ref[0].startswith('"""')
    in_port, in_ref = MAY_DIFFER.get(rel, ({1}, {1}))
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, ref, port, autojunk=False).get_opcodes():
        if tag != "equal":
            assert (set(range(j1 + 1, j2 + 1)) <= in_port
                    and set(range(i1 + 1, i2 + 1)) <= in_ref), (
                f"{rel}: port lines {j1 + 1}-{j2}, reference lines "
                f"{i1 + 1}-{i2} differ: {port[j1:j2]} != {ref[i1:i2]}")


@pytest.fixture(scope="module")
def models():
    jm = JModel(jconfigs.reduced(ARCH).replace(compute_dtype="float32"))
    jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, Model(CFG), tp


@pytest.fixture
def reg():
    """Registry on its own engine, fast sweeps for test-speed expiry."""
    with Engine("tcp://127.0.0.1:0") as e:
        svc = RegistryService(e, instance_ttl=0.6, sweep_interval=0.1)
        yield e, svc
        svc.close()


class FakeServe:
    """Minimal ServeEngine stand-in (the reference tests' own): completes
    each request with one token per step.  Stamps ``t_submit`` /
    ``t_admit`` like the real engine; an optional ``gate`` event holds
    requests in the queue until set, creating real queue wait."""

    def __init__(self, n_slots=2, auto=True, gate=None):
        self.queue = queue.Queue()
        self.work = threading.Event()
        self.n_slots = n_slots
        self.auto = auto
        self.gate = gate
        self.parked = []
        self._rid = 0
        self._lock = threading.Lock()

    def submit(self, tokens, max_new=32, temperature=0.0, eos_id=-1,
               frontend=None, on_token=None, session_id=None):
        with self._lock:
            self._rid += 1
            req = Request(self._rid, np.asarray(tokens, np.int32), max_new)
        req.t_submit = time.monotonic()
        self.queue.put(req)
        self.work.set()
        return req

    def pending(self):
        return self.queue.qsize()

    def step(self):
        if self.gate is not None and not self.gate.is_set():
            return 0
        n = 0
        while True:
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                return n
            req.t_admit = time.monotonic()
            if self.auto:
                req.out_tokens.append(7)
                req.done_event.set()
                req._fire_done()
                n += 1
            else:
                self.parked.append(req)

    def stats(self):
        return {"active_slots": 0, "n_slots": self.n_slots,
                "queued": self.queue.qsize(), "max_len": 64,
                "occupancy": 0.0, "pinned_sessions": 0,
                "prefix_hits": 0, "prefix_misses": 0}


# ---------------------------------------------------------------------------
# mirrors of tests/test_fabric.py
# ---------------------------------------------------------------------------
def test_gateway_self_registers_and_routes_through_pool(reg):
    reg_e, _ = reg
    serves = [FakeServe(), FakeServe()]
    engines = [Engine("tcp://127.0.0.1:0") for _ in serves]
    gws = [ServingGateway(e, s, registry=reg_e.uri, service="gen",
                          report_interval=0.1)
           for e, s in zip(engines, serves)]
    with Engine("tcp://127.0.0.1:0") as cli:
        pool = ServicePool(cli, reg_e.uri, "gen", balancer="rr",
                           refresh_interval=0.1,
                           policy=RetryPolicy(attempts=4, rpc_timeout=5.0,
                                              backoff_base=0.01))
        assert len(pool.replicas()) == 2
        outs = [pool.call("gen.generate", {"tokens": [1, 2], "max_new": 4},
                          timeout=15.0) for _ in range(4)]
        assert all(o["done"] for o in outs)
        # capacity was piggybacked from n_slots
        assert all(r.capacity == 2 for r in pool.replicas())
        # kill one replica: calls keep succeeding, view shrinks on expiry
        gws[0].instance.close(deregister=False)
        gws[0].stop()
        engines[0].shutdown()
        assert all(pool.call("gen.generate",
                             {"tokens": [3], "max_new": 2},
                             timeout=15.0)["done"] for _ in range(4))
    gws[1].close()
    engines[1].shutdown()


def test_gateway_sheds_overload_fast():
    """A gateway whose backlog x EWMA service time exceeds the caller's
    budget sheds with Ret.OVERLOAD in sub-RPC time instead of queueing
    doomed work; generous budgets are still admitted."""
    serve = FakeServe()
    with Engine("tcp://127.0.0.1:0") as srv, \
            Engine("tcp://127.0.0.1:0") as cli:
        gw = ServingGateway(srv, serve)
        for _ in range(3):             # past min_samples: 500ms/request
            gw.admission.observe(0.5)
        t0 = time.monotonic()
        with pytest.raises(RemoteError) as ei:
            cli.call(srv.uri, "gen.submit", {"tokens": [1]}, timeout=0.2)
        assert ei.value.ret == Ret.OVERLOAD
        assert time.monotonic() - t0 < 0.19, "shed must be a fast-fail"
        out = cli.call(srv.uri, "gen.submit", {"tokens": [1]}, timeout=5.0)
        assert "rid" in out
        st = cli.call(srv.uri, "gen.stats", {}, timeout=5.0)
        assert st["shed"] == 1 and st["admitted"] >= 1
        gw.close()


def test_gateway_admission_excludes_queue_wait():
    """Requests held in the gateway queue must not inflate the service
    EWMA: t_admit (slot entry) is the measurement origin, t_submit only
    feeds the separate turnaround EWMA."""
    gate = threading.Event()
    serve = FakeServe(auto=False, gate=gate)
    with Engine("tcp://127.0.0.1:0") as e:
        gw = ServingGateway(e, serve)
        try:
            with Engine("tcp://127.0.0.1:0") as cli:
                cli.call(e.uri, "gen.submit", {"tokens": [1]}, timeout=5.0)
            time.sleep(0.5)            # queue wait: gate still closed
            gate.set()                 # admit: slot occupancy starts
            poll_until(lambda: serve.parked, timeout=5.0, interval=0.01,
                       msg="request admitted")
            time.sleep(0.25)           # service time
            req = serve.parked[0]
            req.done_event.set()
            req._fire_done()
            st = gw.admission.stats()
            assert st["admission_samples"] == 1
            assert st["ema_service_ms"] < 550
            assert st["ema_turnaround_ms"] > 650
            assert st["ema_turnaround_ms"] > st["ema_service_ms"] + 300
        finally:
            gw.close()


def test_gateway_close_joins_step_loop():
    with Engine("tcp://127.0.0.1:0") as e:
        gw = ServingGateway(e, FakeServe())
        assert gw._thread.is_alive()
        gw.close()
        assert not gw._thread.is_alive()
        gw.close()                     # idempotent


# ---------------------------------------------------------------------------
# mirror of tests/test_serve_and_train.py::test_gateway_sm_bulk_submit
# ---------------------------------------------------------------------------
def test_gateway_sm_bulk_submit(models):
    """Gateway over the shared-memory tier: the prompt never rides the
    eager message, the gateway pulls it from the client's registered
    memory (gen.submit_bulk)."""
    _, _, m, params = models
    tag = uuid.uuid4().hex[:8]
    with Engine(f"sm://tgw-{tag}") as srv, Engine(f"sm://tgwc-{tag}") as cli:
        gw = ServingGateway(srv, ServeEngine(m, params, max_len=64,
                                             n_slots=2, device="cpu"))
        tokens = np.asarray([1, 2, 3], np.int32)
        h = cli.expose([tokens])
        out = cli.call(srv.uri, "gen.submit_bulk",
                       {"desc": h.descriptor().to_bytes(), "count": 3,
                        "max_new": 4}, timeout=120.0)
        res = cli.call(srv.uri, "gen.result",
                       {"rid": out["rid"], "wait": True, "timeout": 60.0},
                       timeout=120.0)
        h.free()
        assert res["done"] and len(res["tokens"]) == 4
        stats = cli.call(srv.uri, "gen.stats", {})
        assert "sm://" in stats["uris"]
        gw.stop()


# ---------------------------------------------------------------------------
# mirrors of tests/test_services.py (membership)
# ---------------------------------------------------------------------------
def test_membership_failure_detection():
    with Engine("tcp://127.0.0.1:0") as coord, \
            Engine("tcp://127.0.0.1:0") as w1, \
            Engine("tcp://127.0.0.1:0") as w2:
        ms = MembershipServer(coord, heartbeat_timeout=0.5,
                              sweep_interval=0.1)
        changes = []
        c1 = MembershipClient(w1, coord.uri, "w1", 0.1,
                              on_change=lambda v: changes.append(v))
        c2 = MembershipClient(w2, coord.uri, "w2", 0.1)
        c1.join()
        c2.join()
        poll_until(lambda: c1.current_view()["members"] == ["w1", "w2"],
                   timeout=5.0, interval=0.05, msg="both members seen")
        c2._stop.set()                 # w2's heartbeats stop: node failure
        poll_until(lambda: c1.current_view()["members"] == ["w1"],
                   timeout=5.0, interval=0.1, msg="w2 expired")
        assert changes, "on_change must fire on epoch bump"
        ms.stop()
        c1.leave()


def test_membership_heartbeat_rejoin_preserves_meta():
    """An expired member re-announcing via heartbeat keeps its metadata,
    on the server's path and through the client's heartbeat loop."""
    with Engine("tcp://127.0.0.1:0") as coord, \
            Engine("tcp://127.0.0.1:0") as w:
        ms = MembershipServer(coord, heartbeat_timeout=0.3,
                              sweep_interval=0.05)
        meta = {"role": "trainer", "rank": 3}
        w.call(coord.uri, "mem.join",
               {"member_id": "m", "uri": w.uri, "meta": meta})
        poll_until(lambda: ms.table.get("m") is None, timeout=5.0,
                   interval=0.05, msg="m expired")
        view = w.call(coord.uri, "mem.heartbeat",
                      {"member_id": "m", "uri": w.uri, "meta": meta})
        assert "m" in view["members"]
        assert ms.table.get("m")["meta"] == meta

        c = MembershipClient(w, coord.uri, "c1", 0.05)
        c.join({"zone": "a"})
        with ms.core._lock:              # force-expire behind its back
            ms.table.delete("c1")

        def rejoined():
            rec = ms.table.get("c1")
            return rec is not None and rec["meta"] == {"zone": "a"}
        poll_until(rejoined, timeout=5.0, interval=0.05,
                   msg="client heartbeat re-joined with its metadata")
        c.leave()
        ms.close()


# ---------------------------------------------------------------------------
# mirrors of tests/test_serve_sessions.py (affinity)
# ---------------------------------------------------------------------------
class _Rep:
    def __init__(self, iid):
        self.iid = iid


def test_prefer_instance_ordering():
    ranked = [_Rep("a"), _Rep("b"), _Rep("c")]
    assert prefer_instance(ranked, None) is ranked
    out = prefer_instance(ranked, "b")
    assert [r.iid for r in out] == ["b", "a", "c"]
    assert [r.iid for r in prefer_instance(ranked, "zz")] == ["a", "b", "c"]
    assert prefer_instance([], "a") == []


class _FakePool:
    """Scripted pool: serves the preferred replica while it is live,
    recording what prefer= each call carried."""

    def __init__(self, default_iid):
        self.default = default_iid
        self.live = {default_iid}
        self.prefers = []

    def call_routed(self, rpc, arg=None, prefer=None, **kw):
        self.prefers.append(prefer)
        iid = prefer if prefer in self.live else self.default
        return {"ok": True}, iid


def test_session_affinity_hit_miss_move():
    pool = _FakePool("r1")
    aff = SessionAffinity(pool)
    _, iid = aff.call_routed("s1", "gen.generate", {})
    assert iid == "r1" and aff.misses == 1
    _, iid = aff.call_routed("s1", "gen.generate", {})
    assert iid == "r1" and aff.hits == 1
    assert pool.prefers == [None, "r1"]
    pool.default = "r2"
    pool.live = {"r2"}
    _, iid = aff.call_routed("s1", "gen.generate", {})
    assert iid == "r2" and aff.moves == 1
    assert aff.lookup("s1") == "r2"
    aff.forget("s1")
    assert aff.lookup("s1") is None
    st = aff.stats()
    assert (st["hits"], st["misses"], st["moves"]) == (1, 1, 1)


def test_session_affinity_lru_capacity():
    pool = _FakePool("r1")
    aff = SessionAffinity(pool, capacity=2)
    for sid in ("a", "b", "c"):
        aff.call_routed(sid, "gen.generate", {})
    assert aff.lookup("a") is None
    assert aff.lookup("b") == "r1" and aff.lookup("c") == "r1"


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def test_serve_launcher_registers_and_joins(monkeypatch):
    """``launch/serve.py --registry --member-id``: the demo's gateway is
    an instance of its service while it runs and a member of the control
    plane, and leaves both when it stops."""
    from repro_torch.launch import serve as launcher
    with Engine("tcp://127.0.0.1:0") as reg_e, \
            Engine("tcp://127.0.0.1:0") as cli:
        svc = RegistryService(reg_e, serve_membership=True)
        seen = []
        rc = RegistryClient(cli, reg_e.uri)
        orig = ServingGateway.__init__

        def spy(self, *a, **kw):
            orig(self, *a, **kw)
            seen.append((rc.resolve("gen-demo")["instances"],
                         svc.membership.table.get("gw-demo")))
        monkeypatch.setattr(ServingGateway, "__init__", spy)
        outs, _ = launcher.main(
            ["--reduced", "--demo", "--device", "cpu", "--registry",
             reg_e.uri, "--service", "gen-demo", "--member-id", "gw-demo"])
        assert len(outs) == 6 and all(o["done"] for o in outs)
        (instances, member), = seen
        assert len(instances) == 1 and instances[0]["capacity"] == 4
        assert member["meta"] == {"role": "gateway", "service": "gen-demo"}
        assert rc.resolve("gen-demo")["instances"] == []
        assert svc.membership.table.get("gw-demo") is None
        svc.close()


def _free_base_port():
    import socket
    socks = []
    try:
        for _ in range(4):   # grab a base with base+1 free alongside
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return max(s.getsockname()[1] for s in socks) + 7
    finally:
        for s in socks:
            s.close()


def _owned_by(client, shard, prefix):
    for i in range(10_000):
        name = f"{prefix}-{i}"
        if client.shard_of(name) == shard:
            return name
    raise AssertionError(f"no name owned by shard {shard}")


def test_registry_launcher_cohosts_shards():
    """``python -m repro_torch.launch.registry --shards 2`` co-hosts two
    quorums on port and port+1; a sharded client registers a service on
    each."""
    base = _free_base_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.registry",
         "--listen", f"tcp://127.0.0.1:{base}", "--shards", "2",
         "--instance-ttl", "30"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    cli = Engine("tcp://127.0.0.1:0")
    try:
        spec = f"tcp://127.0.0.1:{base}|tcp://127.0.0.1:{base + 1}"
        c = ShardedRegistryClient(cli, spec, timeout=2.0)

        def reachable(shard):
            try:
                shard.epoch(fresh=True)
                return True
            except Exception:
                return False
        for shard in c.clients:
            poll_until(lambda s=shard: reachable(s), timeout=60.0,
                       msg="co-hosted shard up")
        svc0, svc1 = _owned_by(c, 0, "co"), _owned_by(c, 1, "co")
        c.register(svc0, ["tcp://10.0.0.1:1"])
        c.register(svc1, ["tcp://10.0.0.1:2"])
        assert c.services() == sorted([svc0, svc1])
        infos = c.epoch_info(fresh=True)
        assert infos[0][1] != infos[1][1]
    finally:
        cli.shutdown()
        p.terminate()
        p.wait(timeout=10)


# ---------------------------------------------------------------------------
# the slice against the reference
# ---------------------------------------------------------------------------
N_CONV, N_TURNS, FIRST, MAX_NEW, FRESH = 2, 3, 12, 4, 3
ENGINE_KW = dict(max_len=64, n_slots=2, chunk_tokens=8, session_cap=4)


def _conversations(call):
    """N_CONV conversations of N_TURNS greedy turns; ``call(sid, tokens)``
    returns the turn's new tokens.  Each turn appends its tokens and
    FRESH more to the history."""
    rng = np.random.default_rng(5)
    hist = {f"conv{c}": rng.integers(1, CFG.vocab, FIRST).tolist()
            for c in range(N_CONV)}
    out = {sid: [] for sid in hist}
    for _ in range(N_TURNS):
        for sid in hist:
            toks = call(sid, hist[sid])
            out[sid].append(toks)
            hist[sid] = (hist[sid] + toks
                         + rng.integers(1, CFG.vocab, FRESH).tolist())
    return out


def _routed_run(pkg, make_serve):
    """Registry, two gateways and a client pool + affinity, all of one
    package (``pkg`` names its modules); returns the conversations'
    tokens, the affinity's stats and the replicas' summed prefix hits."""
    import importlib
    executor = importlib.import_module(f"{pkg}.core.executor")
    fabric = importlib.import_module(f"{pkg}.fabric")
    services = importlib.import_module(f"{pkg}.services")
    E = executor.Engine
    with E("tcp://127.0.0.1:0") as reg_e, E("tcp://127.0.0.1:0") as cli:
        registry = fabric.RegistryService(reg_e)
        engines = [E("tcp://127.0.0.1:0") for _ in range(2)]
        gws = [services.ServingGateway(e, make_serve(), registry=reg_e.uri,
                                       service="gen-conv",
                                       report_interval=0.1)
               for e in engines]
        try:
            pool = fabric.ServicePool(
                cli, reg_e.uri, "gen-conv", balancer="rr",
                credits_per_target=8, adaptive_credits=False,
                policy=fabric.RetryPolicy(attempts=4, rpc_timeout=120.0))
            assert len(pool.replicas()) == 2
            aff = fabric.SessionAffinity(pool)

            def call(sid, tokens):
                res, _iid = aff.call_routed(
                    sid, "gen.generate",
                    {"tokens": tokens, "max_new": MAX_NEW,
                     "session_id": sid}, timeout=180.0)
                assert res["done"]
                return list(res["tokens"])
            tokens = _conversations(call)
            hits = sum(cli.call(e.uri, "gen.stats", {},
                                timeout=30.0)["prefix_hits"]
                       for e in engines)
            return tokens, aff.stats(), hits
        finally:
            for gw, e in zip(gws, engines):
                gw.close()
                e.shutdown()
            registry.close()


def test_routed_conversations_match_reference(models):
    """Two conversations of three greedy turns through registry, pool,
    affinity and two gateways: the port's tokens equal the reference's on
    the same weights, in f32, and every follow-up resumes its session."""
    from repro.serve.engine import ServeEngine as JServeEngine
    jm, jp, tm, tp = models
    want, jaff, jhits = _routed_run(
        "repro", lambda: JServeEngine(jm, jp, cache_dtype=jnp.float32,
                                      **ENGINE_KW))
    got, aff, hits = _routed_run(
        "repro_torch", lambda: ServeEngine(tm, tp, cache_dtype=torch.float32,
                                           device="cpu", **ENGINE_KW))
    assert got == want
    follow_ups = N_CONV * (N_TURNS - 1)
    assert (aff["hits"], aff["misses"], aff["moves"]) == (follow_ups,
                                                          N_CONV, 0)
    assert (jaff["hits"], jaff["misses"], jaff["moves"]) == (follow_ups,
                                                             N_CONV, 0)
    assert hits == jhits == follow_ups


def test_port_gateway_in_reference_registry_and_pool(models):
    """The wire crosses packages: a port gateway registers (and joins the
    membership plane) with the reference's RegistryService and answers
    the reference's ServicePool, with the reference engine's tokens."""
    from repro.core.executor import Engine as JEngine
    from repro.fabric import RegistryService as JRegistryService
    from repro.fabric import ServicePool as JServicePool
    from repro.serve.engine import ServeEngine as JServeEngine
    jm, jp, tm, tp = models
    prompt = list(range(1, 15))
    want = JServeEngine(jm, jp, cache_dtype=jnp.float32,
                        **ENGINE_KW).generate([prompt], max_new=MAX_NEW)[0]
    with JEngine("tcp://127.0.0.1:0") as reg_e, \
            JEngine("tcp://127.0.0.1:0") as cli, \
            Engine("tcp://127.0.0.1:0") as srv:
        registry = JRegistryService(reg_e, serve_membership=True)
        gw = ServingGateway(srv, ServeEngine(tm, tp, device="cpu",
                                             cache_dtype=torch.float32,
                                             **ENGINE_KW),
                            registry=reg_e.uri, service="gen-x",
                            member_id="port-gw", report_interval=0.1)
        try:
            assert registry.membership.table.get("port-gw") is not None
            pool = JServicePool(cli, reg_e.uri, "gen-x")
            out = pool.call("gen.generate", {"tokens": prompt,
                                             "max_new": MAX_NEW},
                            timeout=60.0)
            assert out["done"] and out["tokens"] == want
        finally:
            gw.close()
        assert registry.membership.table.get("port-gw") is None
        registry.close()
