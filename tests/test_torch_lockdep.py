"""The port's lock-order sanitizer (``repro_torch.analysis.lockdep``).

First the reference's lockdep unit tests (tests/test_analysis.py), as
cases of one test run on the port's module.  Then the gate: a subprocess
installs the port's lockdep before any ``repro_torch.fabric`` import,
drives registry (with its membership plane), two gateways that join it,
a pool, session affinity and a replica's death on the reduced model on
the CPU, and asserts that no lock-order cycle and no lock held across an
RPC was recorded, with locks created under ``repro_torch/`` tracked (so
the check cannot pass on an empty graph)."""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import lockdep  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _mk(graph, name):
    return lockdep.wrap(threading.Lock(), name, graph)


def _two_lock_inversion_is_a_cycle():
    g = lockdep.LockGraph(metrics=False)
    a, b = _mk(g, "A"), _mk(g, "B")

    def order_ab():
        with a:
            with b:
                pass

    def order_ba():
        with b:
            with a:
                pass

    for fn in (order_ab, order_ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    rep = g.report()
    assert rep["cycles"], rep
    assert set(rep["cycles"][0]["cycle"]) >= {"A", "B"}
    with pytest.raises(AssertionError, match="cycle"):
        g.assert_clean()


def _consistent_order_is_clean():
    g = lockdep.LockGraph(metrics=False)
    a, b = _mk(g, "A"), _mk(g, "B")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = g.report()
    assert rep["edges"] == 1 and not rep["cycles"]
    g.assert_clean()


def _same_site_nesting_not_a_cycle():
    g = lockdep.LockGraph(metrics=False)
    a1 = lockdep.wrap(threading.Lock(), "repro_torch/x.py:10", g)
    a2 = lockdep.wrap(threading.Lock(), "repro_torch/x.py:10", g)
    with a1:
        with a2:
            pass
    rep = g.report()
    assert rep["edges"] == 0 and not rep["cycles"]


def _reentrant_rlock_no_self_edge():
    g = lockdep.LockGraph(metrics=False)
    r = lockdep.wrap(threading.RLock(), "R", g)
    with r:
        with r:
            pass
    assert not g.report()["cycles"]
    assert not g.held_sites()


def _condition_over_tracked_lock():
    g = lockdep.LockGraph(metrics=False)
    lk = lockdep.wrap(threading.Lock(), "CV", g)
    cv = threading.Condition(lk)
    hit = []

    def waiter():
        with cv:
            while not hit:
                cv.wait(1.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        hit.append(1)
        cv.notify_all()
    t.join(2.0)
    assert not t.is_alive()
    assert not g.held_sites()          # wait() dropped it from the stack
    g.assert_clean()


def _lock_held_across_rpc():
    g = lockdep.LockGraph(metrics=False)
    lk = _mk(g, "repro_torch/svc.py:5")
    with lk:
        g.note_rpc("Engine.call")
    rep = g.report()
    assert rep["rpc_violations"] and \
        rep["rpc_violations"][0]["held"] == ["repro_torch/svc.py:5"]
    with pytest.raises(AssertionError, match="RPC boundary"):
        g.assert_clean()


def _rpc_without_lock_is_clean():
    g = lockdep.LockGraph(metrics=False)
    lk = _mk(g, "L")
    with lk:
        pass
    g.note_rpc("Engine.call")
    assert not g.report()["rpc_violations"]


def _hold_time_histogram():
    from repro_torch.telemetry import metrics
    g = lockdep.LockGraph(metrics=True)
    lk = lockdep.wrap(threading.Lock(), "repro_torch/hold.py:1", g)
    with lk:
        pass
    key = "analysis.lock.hold_ms{site=repro_torch/hold.py:1}"
    snap = metrics.snapshot()["histograms"]
    assert key in snap and snap[key]["count"] >= 1


def _install_wraps_new_locks():
    assert lockdep.graph() is None
    g = lockdep.install(prefixes=None)          # track every site
    try:
        lk = threading.Lock()
        assert isinstance(lk, lockdep.TrackedLock)
        with lk:
            pass
        assert g.acquisitions >= 1
    finally:
        lockdep.uninstall()
    assert not isinstance(threading.Lock(), lockdep.TrackedLock)


def _install_excludes_metrics_registry():
    assert lockdep.graph() is None
    lockdep.install(prefixes=None)
    try:
        from repro_torch.telemetry import metrics
        h = metrics.REGISTRY.histogram("analysis.selftest.hold_ms")
        assert not isinstance(h._lock, lockdep.TrackedLock)
    finally:
        lockdep.uninstall()


UNIT_CASES = {
    "two_lock_inversion_is_a_cycle": _two_lock_inversion_is_a_cycle,
    "consistent_order_is_clean": _consistent_order_is_clean,
    "same_site_nesting_not_a_cycle": _same_site_nesting_not_a_cycle,
    "reentrant_rlock_no_self_edge": _reentrant_rlock_no_self_edge,
    "condition_over_tracked_lock": _condition_over_tracked_lock,
    "lock_held_across_rpc": _lock_held_across_rpc,
    "rpc_without_lock_is_clean": _rpc_without_lock_is_clean,
    "hold_time_histogram": _hold_time_histogram,
    "install_wraps_new_locks": _install_wraps_new_locks,
    "install_excludes_metrics_registry": _install_excludes_metrics_registry,
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_lockdep_unit(case):
    UNIT_CASES[case]()


# the fabric under the port's lockdep: installed before anything of the
# fabric, then registry + membership, two gateways on the reduced model,
# a pool with session affinity, one replica's death and clean closes
_DRIVE = """
import json, sys
from repro_torch.analysis import lockdep
graph = lockdep.install()
from repro_torch import configs
from repro_torch.core.executor import Engine
from repro_torch.fabric import (RegistryService, RetryPolicy, ServicePool,
                                SessionAffinity)
from repro_torch.models import Model
from repro_torch.serve.engine import ServeEngine
from repro_torch.services import ServingGateway
from repro_torch.telemetry import metrics

cfg = configs.reduced("qwen1.5-0.5b")
model = Model(cfg)
params = model.init(0, device="cpu")
with Engine("tcp://127.0.0.1:0") as reg_e, \\
        Engine("tcp://127.0.0.1:0") as cli:
    registry = RegistryService(reg_e, instance_ttl=0.6, sweep_interval=0.1,
                               serve_membership=True, heartbeat_timeout=0.6)
    engines = [Engine("tcp://127.0.0.1:0") for _ in range(2)]
    gws = [ServingGateway(e, ServeEngine(model, params, max_len=64,
                                         n_slots=2, chunk_tokens=8,
                                         session_cap=4, device="cpu"),
                          registry=reg_e.uri, service="gen-ld",
                          member_id=f"gw{i}", report_interval=0.1)
           for i, e in enumerate(engines)]
    pool = ServicePool(cli, reg_e.uri, "gen-ld", balancer="rr",
                       refresh_interval=0.1,
                       policy=RetryPolicy(attempts=4, rpc_timeout=30.0,
                                          backoff_base=0.01))
    aff = SessionAffinity(pool)
    hist = {f"s{c}": list(range(1 + c, 11 + c)) for c in range(3)}
    for turn in range(3):
        if turn == 2:                  # a replica dies between turns
            gws[0].instance.close(deregister=False)
            gws[0].stop()
            engines[0].shutdown()
        for sid in hist:
            res, _ = aff.call_routed(sid, "gen.generate",
                                     {"tokens": hist[sid], "max_new": 2,
                                      "session_id": sid}, timeout=60.0)
            assert res["done"] and len(res["tokens"]) == 2, res
            hist[sid] = hist[sid] + res["tokens"] + [5, 6]
    gws[1].close()
    engines[1].shutdown()
    registry.close()
sites = sorted({k.split("site=", 1)[1].rstrip("}")
                for k in metrics.snapshot()["histograms"]
                if k.startswith("analysis.lock.hold_ms")})
rep = lockdep.report()
print(json.dumps({"sites": sites, "edges": rep["edges"],
                  "acquisitions": rep["acquisitions"],
                  "cycles": rep["cycles"],
                  "rpc_violations": rep["rpc_violations"],
                  "affinity": aff.stats()}))
lockdep.assert_clean()
"""


def test_fabric_under_port_lockdep_is_clean():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _DRIVE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert not rep["cycles"] and not rep["rpc_violations"], rep
    port_sites = [s for s in rep["sites"] if s.startswith("repro_torch/")]
    assert any(s.startswith("repro_torch/fabric/") for s in port_sites), rep
    assert any(s.startswith("repro_torch/services/") for s in port_sites)
    assert rep["acquisitions"] > 0
    assert rep["affinity"]["moves"] + rep["affinity"]["misses"] > 3, rep
