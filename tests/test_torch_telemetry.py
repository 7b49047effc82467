"""The port's profiler regions (``telemetry.trace.region``) on the CPU:
nothing recorded without a profiler; under ``torch.profiler`` a training
step (plain, two microbatches, Adafactor, and the sharded step on two
gloo ranks) shows ``train.step`` holding one ``train.optimizer`` and a
``train.forward`` and ``train.backward`` a microbatch; a region is an
op-scope host event, never a user annotation (which the card's trace
would mirror as device time); a ``DataFeedClient.get`` over tcp shows
``datafeed.get`` holding ``datafeed.wait`` with its step, and counts
into the ``service.datafeed.wait_ms`` histogram."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs, telemetry  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core.executor import Engine  # noqa: E402
from repro_torch.data.pipeline import SyntheticSource  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.services import DataFeedClient, DataFeedServer  # noqa: E402
from repro_torch.telemetry import trace  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

ARCH = "qwen1.5-0.5b"
B, S, STEPS = 4, 16, 2
TRAIN = ("train.step", "train.forward", "train.backward", "train.optimizer")
FEED = ("datafeed.get", "datafeed.wait", "datafeed.pull")


def region_events(prof, names):
    """(name, start_ns, end_ns) of the kineto events named ``names``, in
    start order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in names), key=lambda x: x[1])


def check_nesting(evs, microbatches):
    """Each ``train.step`` holds one optimizer and a forward and backward
    a microbatch; no train region lies outside a step."""
    steps = [(s, e) for n, s, e in evs if n == "train.step"]
    assert len(steps) == STEPS
    for lo, hi in steps:
        inside = [n for n, s, e in evs
                  if lo <= s and e <= hi and n != "train.step"]
        assert inside.count("train.optimizer") == 1
        assert inside.count("train.forward") == microbatches
        assert inside.count("train.backward") == microbatches
        # forward then backward, microbatch by microbatch; the optimizer
        # last
        assert inside == (["train.forward", "train.backward"]
                          * microbatches + ["train.optimizer"])
    assert len(evs) == STEPS * (2 + 2 * microbatches)


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = torch.from_numpy(rng.integers(0, vocab, (B, S + 1)))
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def test_region_records_nothing_without_a_profiler():
    with trace.region("train.step"), trace.region("datafeed.wait", step=3):
        x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert region_events(prof, ("train.step", "datafeed.wait")) == []


def test_telemetry_exports_region():
    assert telemetry.region is trace.region


@pytest.mark.parametrize("variant", ["plain", "microbatches2", "adafactor"])
def test_train_step_regions_nest(variant):
    model = Model(configs.reduced(ARCH).replace(compute_dtype="float32"))
    ocfg = optim.OptConfig(name="adafactor" if variant == "adafactor"
                           else "adamw")
    micro = 2 if variant == "microbatches2" else 1
    state = init_state(model, ocfg, 0, device="cpu")
    step = make_train_step(model, ocfg, ParallelConfig(microbatches=micro))
    batches = _batches(model.cfg.vocab)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for batch in batches:
            state, met = step(state, batch)
    assert np.isfinite(float(met["loss"]))
    check_nesting(region_events(prof, TRAIN), micro)


def test_sharded_train_step_regions_nest():
    """The sharded step on a (data 2, model 1) mesh: each rank's regions
    nest as the local step's, an all-reduce (the gradient norm's) inside
    each ``train.optimizer``."""
    outs = run_ranks("torch_region_scenarios", "sharded_regions", 2,
                     {"arch": ARCH, "batches": [
                         {k: v.numpy() for k, v in b.items()}
                         for b in _batches(configs.reduced(ARCH).vocab)]})
    for out in outs:
        check_nesting(out["regions"], 1)
        opt = [(s, e) for n, s, e in out["regions"]
               if n == "train.optimizer"]
        assert all(any(s <= t <= e for t in out["all_reduces"])
                   for s, e in opt)


def test_region_is_an_op_scope_host_event():
    """A region is a host event of the function scope; the same name
    under ``record_function`` is a user annotation, the kind the card's
    trace mirrors on the device."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.region("train.step"):
            torch.ones(4).sum()
        with torch.profiler.record_function("user.range"):
            torch.ones(4).sum()
    kin = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert kin["train.step"].device_type() == DeviceType.CPU
    assert not kin["train.step"].is_user_annotation()
    assert kin["user.range"].is_user_annotation()
    scope = {e.name: e.scope for e in prof.events()}
    assert scope["train.step"] == 0            # at::RecordScope::FUNCTION
    assert scope["user.range"] != 0


def test_region_carries_its_args_when_inputs_are_recorded():
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with trace.region("datafeed.wait", step=7):
            pass
    ev = [e for e in prof.events() if e.name == "datafeed.wait"]
    assert len(ev) == 1 and ev[0].kwinputs == {"step": 7}


@pytest.mark.parametrize("mode", ["eager", "bulk"])
def test_datafeed_get_regions_and_wait_histogram(mode):
    src = SyntheticSource(vocab=100, seq_len=32, batch_per_host=2)
    hist = telemetry.histogram("service.datafeed.wait_ms")
    before = hist.snapshot()["count"]
    with Engine("tcp://127.0.0.1:0") as fe, \
            Engine("tcp://127.0.0.1:0") as tr:
        DataFeedServer(fe, src,
                       eager_limit=1 << 30 if mode == "eager" else 1)
        cli = DataFeedClient(tr, [fe.uri], depth=2)
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            for step in range(3):
                got = cli.get(step)
                np.testing.assert_array_equal(
                    got["tokens"], src.batch_at(step)["tokens"])
    evs = region_events(prof, FEED)
    gets = [(s, e) for n, s, e in evs if n == "datafeed.get"]
    assert len(gets) == 3
    for lo, hi in gets:
        inside = [n for n, s, e in evs if lo <= s and e <= hi]
        want = ["datafeed.get", "datafeed.wait"]
        assert inside == want + (["datafeed.pull"] if mode == "bulk" else [])
    waits = [e for e in prof.events() if e.name == "datafeed.wait"]
    assert [w.kwinputs["step"] for w in waits] == [0, 1, 2]
    snap = hist.snapshot()
    assert snap["count"] == before + 3
    assert "service.datafeed.wait_ms" in telemetry.snapshot()["histograms"]
