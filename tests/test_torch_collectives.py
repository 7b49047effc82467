"""The port's collectives and mesh (``repro_torch.distrib.collectives``,
``repro_torch.launch.mesh``) against the reference's.

``quantize_int8`` is bitwise the reference's.  The rest runs once per
module as 4 gloo ranks on the CPU (``torch_ranks``, 120 s limit), and
each case reads those results:

* ``compressed_psum`` over a (data 4) mesh against
  ``jax.vmap(compressed_psum, axis_name="data")`` on the same rows: the
  same arithmetic in the same order, so the mean and the error agree to
  the rounding of the last division (rtol 1e-6, atol 1e-7 of values
  ~1); the mean within 0.75 of the scale of the exact mean (the
  reference test's bound); the error-feedback toy converges (< 0.05) and
  ``compressed_allreduce_tree`` is ``compressed_psum`` leaf by leaf.
* ``sp_decode_attention`` over a (data 1, model 4) mesh, with and without
  softcap, against the reference's ``sp_decode_attention`` run on 4 XLA
  host devices in a subprocess (as ``tests/test_distrib.py`` runs it) at
  2e-4, and against attention over the whole cache.
* The mesh: coordinates in row-major rank order, ``local_block`` /
  ``gather_block`` against numpy slicing, reductions of bf16 in f32, and
  the meshes it must refuse (a production mesh on 4 ranks, NCCL without
  a card, an unknown backend, a model axis that does not divide the
  world).
"""
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.distrib import collectives as rc  # noqa: E402
from repro_torch.distrib import collectives as pc  # noqa: E402
from repro_torch.kernels.attention import attention_plain  # noqa: E402
from torch_ranks import ROOT, run_ranks  # noqa: E402

SOFTCAPS = (0.0, 5.0)
PSUM = {"row": (4, 64), "matrix": (4, 8, 16), "tiny": (4, 3),
        "scaled": (4, 33)}


def _args():
    rng = np.random.default_rng(0)
    psum = {k: rng.standard_normal(s).astype(np.float32) for k, s in
            PSUM.items()}
    psum["scaled"] *= np.float32(1e-4)
    X = rng.standard_normal((4, 64, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    B, T, Hq, Hkv, D = 2, 64, 4, 2, 16
    sp = {"q": rng.standard_normal((B, 1, Hq, D)).astype(np.float32),
          "k": rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
          "v": rng.standard_normal((B, T, Hkv, D)).astype(np.float32)}
    blocks = {
        "whole": (rng.standard_normal((8, 6, 4)).astype(np.float32),
                  ("data", "model"), None),
        "over_data": (rng.standard_normal((4, 6)).astype(np.float32),
                      ("model", "data"), ("data",)),
        "last_dim": (rng.standard_normal((3, 8)).astype(np.float32),
                     (None, ("data", "model")), None),
        "replicated": (rng.standard_normal((5,)).astype(np.float32), (),
                       None)}
    return {"psum": psum,
            "toy": {"X": X, "w": w, "y": np.einsum("dbi,i->db", X, w)},
            "tree": {"a": rng.standard_normal((4, 5, 3)).astype(np.float32),
                     "b": rng.standard_normal((4, 7)).astype(np.float32)},
            "sp": sp, "softcaps": SOFTCAPS, "blocks": blocks}


SP_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, numpy as np
    from repro.distrib.collectives import sp_decode_attention
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    out = {}
    for softcap in (0.0, 5.0):
        with mesh:
            out[str(softcap)] = np.asarray(jax.jit(
                lambda q, k, v: sp_decode_attention(
                    q, k, v, mesh, seq_axis="model", softcap=softcap))(
                        d["q"], d["k"], d["v"]))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    args = _args()
    ranks = run_ranks("torch_dist_scenarios", "collectives", 4, args)
    tmp = tmp_path_factory.mktemp("sp")
    np.savez(tmp / "in.npz", **args["sp"])
    r = subprocess.run([sys.executable, "-c", SP_REF, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    sp_ref = dict(np.load(tmp / "out.npz"))
    return args, ranks, sp_ref


@pytest.mark.parametrize("seed", range(6))
def test_quantize_int8_is_the_references(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((7, 33)) * 10.0 ** (seed - 3)).astype(
        np.float32)
    if seed == 5:
        x[:] = 0.0                        # the scale's 1e-12 floor
    q, s = pc.quantize_int8(torch.from_numpy(x))
    jq, js = rc.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(
        pc.dequantize_int8(q, s).numpy(),
        np.asarray(rc.dequantize_int8(jq, js)))


@pytest.mark.parametrize("name", sorted(PSUM))
def test_compressed_psum_matches_reference(run, name):
    args, ranks, _ = run
    x = args["psum"][name]
    jout, jerr = jax.vmap(lambda a: rc.compressed_psum(a, "data"),
                          axis_name="data")(jnp.asarray(x))
    scale = np.abs(x).max() / 127.0
    for rank, res in enumerate(ranks):
        out, err = res[f"psum/{name}"]
        np.testing.assert_allclose(out, np.asarray(jout[rank]), rtol=1e-6,
                                   atol=1e-7 * scale * 127)
        np.testing.assert_allclose(err, np.asarray(jerr[rank]), rtol=1e-6,
                                   atol=1e-7 * scale * 127)
        assert np.abs(out - x.mean(0)).max() <= 0.75 * scale


def test_error_feedback_toy_converges(run):
    _, ranks, _ = run
    d_exact, d_comp, w = ranks[0]["toy"]
    assert d_comp < 0.05, (d_exact, d_comp)
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["toy"][2], w)


def test_compressed_allreduce_tree_is_psum_by_leaf(run):
    args, ranks, _ = run
    xa, xb = args["tree"]["a"], args["tree"]["b"]
    ja, jea = jax.vmap(lambda a: rc.compressed_psum(a, "data"),
                       axis_name="data")(jnp.asarray(xa))
    jb, _ = jax.vmap(lambda a: rc.compressed_psum(a, "data"),
                     axis_name="data")(jnp.asarray(xb))
    for rank, res in enumerate(ranks):
        a, b, ea, a2 = res["tree"]
        np.testing.assert_allclose(a, np.asarray(ja[rank]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(b, np.asarray(jb[rank]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ea, np.asarray(jea[rank]), rtol=1e-6,
                                   atol=1e-7)
        # with the error fed back the mean comes closer to the exact one
        assert np.abs(a2 - xa.mean(0)).max() <= \
            0.75 * np.abs(xa + ea).max() / 127.0 + 1e-6


@pytest.mark.parametrize("softcap", SOFTCAPS)
def test_sp_decode_attention_matches_reference(run, softcap):
    args, ranks, sp_ref = run
    sp = {k: torch.from_numpy(v) for k, v in args["sp"].items()}
    T = sp["k"].shape[1]
    whole = attention_plain(sp["q"], sp["k"], sp["v"], causal=True,
                            softcap=softcap, q_offset=T - 1).numpy()
    for res in ranks:
        got = res[f"sp/{softcap}"]
        np.testing.assert_allclose(got, sp_ref[str(softcap)], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got, whole, rtol=2e-4, atol=2e-4)


def test_mesh_lays_ranks_out_row_major(run):
    _, ranks, _ = run
    for rank, res in enumerate(ranks):
        assert res["data4"] == {"coords": {"data": rank, "model": 0},
                                "shape": {"data": 4, "model": 1}}
        assert res["grid"] == {"coords": {"data": rank // 2,
                                          "model": rank % 2},
                               "index": rank}


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_all_reduce_of_bf16(run, op):
    _, ranks, _ = run
    want = {"sum": [6.0, -6.0], "max": [3.0, 0.0], "min": [0.0, -3.0]}[op]
    for res in ranks:
        np.testing.assert_array_equal(res[f"reduce/{op}"], want)


@pytest.mark.parametrize("name", ["whole", "over_data", "last_dim",
                                  "replicated"])
def test_local_and_gather_block(run, name):
    args, ranks, _ = run
    x, spec, axes = args["blocks"][name]
    for rank, res in enumerate(ranks):
        block, back = res[f"block/{name}"]
        d, m = rank // 2, rank % 2
        if name == "whole":
            want = x[d * 4:(d + 1) * 4, m * 3:(m + 1) * 3]
            np.testing.assert_array_equal(back, x)
        elif name == "over_data":
            want = x[m * 2:(m + 1) * 2, d * 3:(d + 1) * 3]
            # gathered over data only: this model shard's rows, whole cols
            np.testing.assert_array_equal(back, x[m * 2:(m + 1) * 2])
        elif name == "last_dim":
            want = x[:, rank * 2:(rank + 1) * 2]
            np.testing.assert_array_equal(back, x)
        else:
            want = x
            np.testing.assert_array_equal(back, x)
        np.testing.assert_array_equal(block, want)


@pytest.mark.parametrize("name", ["production", "multi_pod", "nccl",
                                  "backend", "model_axis"])
def test_mesh_refuses(run, name):
    _, ranks, _ = run
    want = "RuntimeError" if name == "nccl" else "ValueError"
    for res in ranks:
        assert res["refused"][name] == want, res["refused"]
