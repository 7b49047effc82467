"""The port's pipeline stage runner (``repro_torch.distrib.pipeline``)
against the reference's ``pipeline_apply``.

The port runs once per module as 4 gloo ranks on the CPU (``torch_ranks``,
120 s limit), one stage a rank, over a one-axis (stage,) mesh; the
reference runs the same numpy weights and inputs on 4 XLA host devices
in a subprocess, as ``tests/test_distrib.py`` runs it.  Each case: the
outputs of every rank against the reference's and against the stages
applied in turn in one process, at 2e-4 (the reference test's bound)."""
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import ROOT, run_ranks  # noqa: E402

# name: (microbatches, microbatch shape): the reference test's 8 x (2, 16),
# fewer microbatches than stages, one, and a microbatch of 3-D activations
CASES = {"reference": (8, (2, 16)), "few": (3, (2, 16)),
         "one": (1, (4, 16)), "rows": (5, (2, 3, 16))}

REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.distrib.pipeline import pipeline_apply
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("stage",))
    out = {}
    for name in sorted({k.split("/")[0] for k in d.files}):
        Ws, x = d[name + "/W"], d[name + "/x"]
        with mesh:
            out[name] = np.asarray(jax.jit(lambda W, xx: pipeline_apply(
                lambda w, h: jnp.tanh(h @ w), W, xx, mesh,
                stage_axis="stage"))(Ws, x))
    np.savez(sys.argv[2], **out)
""")


def _args():
    rng = np.random.default_rng(0)
    out = {}
    for name, (n_micro, mb) in CASES.items():
        d = mb[-1]
        Ws = (rng.standard_normal((4, d, d)) * 0.3).astype(np.float32)
        x = rng.standard_normal((n_micro,) + mb).astype(np.float32)
        out[name] = (Ws, x)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    args = _args()
    ranks = run_ranks("torch_dist_scenarios", "pipeline", 4, args)
    tmp = tmp_path_factory.mktemp("pipe")
    flat = {f"{n}/{k}": v for n, (W, x) in args.items()
            for k, v in (("W", W), ("x", x))}
    np.savez(tmp / "in.npz", **flat)
    r = subprocess.run([sys.executable, "-c", REF, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return args, ranks, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_reference(run, name):
    args, ranks, ref = run
    Ws, x = args[name]
    want = x
    for s in range(4):
        want = np.tanh(want @ Ws[s])
    np.testing.assert_allclose(ref[name], want, rtol=2e-4, atol=2e-4)
    for res in ranks:
        np.testing.assert_allclose(res[name], ref[name], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(res[name], want, rtol=2e-4, atol=2e-4)
