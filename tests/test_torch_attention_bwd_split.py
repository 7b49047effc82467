"""The tensor-core attention backward's route and dK/dV row splits, on
the CPU.

The bf16 backward (``csrc/flash_attention_bwd.cu``, ``attn_bwd_dkdv_tc``)
runs one block a (64-key tile, kv head, batch row); under MQA that grid is
short of the card, so ``bwd_plan`` splits each block's packed rows across
blocks, and ``attn_bwd_dkdv_reduce`` sums the f32 partials in a fixed
order.  Here their plain counterparts: each split's partial by
``attention_bwd_dkdv_partial_plain`` and their sum by
``dkdv_reduce_plain`` must equal ``attention_bwd_plain``'s dk and dv at
1e-5 in f32, and ``jax.vjp`` of the reference oracle; ``bwd_plan`` must
choose from shapes and dtype alone.  No card needed; JAX only in the
``ref`` fixture."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as fa  # noqa: E402
from test_torch_attention_bwd import ref  # noqa: E402,F401  (the fixture)

SPLIT_TOL = 1e-5
B, S = 2, 21
# name, Hq, Hkv, D, causal, window, softcap, prefix, T: MQA 8/1 (the
# VLM's prefix-LM) and 16/1 (recurrentgemma's window) at head_dim 256,
# GQA 3 with a softcap, and ragged S != T (21 queries against 9 and 50
# keys, non-causal)
CASES = [
    ("mqa8-d256-prefix", 8, 1, 256, True, 0, 0.0, 12, 21),
    ("mqa16-d256-window", 16, 1, 256, True, 9, 0.0, None, 21),
    ("g3-d64-softcap", 6, 2, 64, True, 0, 30.0, None, 21),
    ("cross-g3-d64-t9", 6, 2, 64, False, 0, 0.0, None, 9),
    ("cross-mqa16-d64-t50", 16, 1, 64, False, 0, 0.0, None, 50),
]


def _inputs(case, seed=0):
    _, Hq, Hkv, D, causal, window, softcap, prefix, T = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D),
                        (B, S, Hq, D))]
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix)
    return arrays, kw


def _split_reduce(q, k, v, o, lse, do, kw, ranges):
    parts = [fa.attention_bwd_dkdv_partial_plain(q, k, v, o, lse, do, lo, hi,
                                                 **kw) for lo, hi in ranges]
    dk, dv = (torch.stack(x) for x in zip(*parts))
    return fa.dkdv_reduce_plain(dk, dv, q.dtype)


@pytest.mark.parametrize("tile", [16, fa.ROWS])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_split_then_reduce_equals_plain(case, n_split, tile):
    """Splits of the packed rows [0, S * G) in whole tiles of the
    kernel's 64 rows and of 16 (so that 21 queries give several non-empty
    splits), some empty."""
    arrays, kw = _inputs(case)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse = fa.attention_fwd_plain(q, k, v, **kw)
    G = q.shape[2] // k.shape[2]
    ranges = fa.key_splits(0, S * G, tile, n_split)
    dk, dv = _split_reduce(q, k, v, o, lse, do, kw, ranges)
    _, want_dk, want_dv = fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=SPLIT_TOL, atol=SPLIT_TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_split_then_reduce_matches_jax_vjp(ref, case):  # noqa: F811
    """Four splits' reduced dk and dv against ``jax.vjp`` of
    ``ref.attention_ref`` on the same numpy inputs, f32."""
    arrays, kw = _inputs(case, seed=1)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse = fa.attention_fwd_plain(q, k, v, **kw)
    G = q.shape[2] // k.shape[2]
    dk, dv = _split_reduce(q, k, v, o, lse, do, kw,
                           fa.key_splits(0, S * G, 16, 4))
    _, want_dk, want_dv = ref(*arrays, "float32", **kw)
    np.testing.assert_allclose(dk.numpy(), want_dk, rtol=SPLIT_TOL,
                               atol=SPLIT_TOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, rtol=SPLIT_TOL,
                               atol=SPLIT_TOL)


def test_partial_outside_every_row_is_zero():
    """A range past the packed rows contributes nothing."""
    arrays, kw = _inputs(CASES[0])
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse = fa.attention_fwd_plain(q, k, v, **kw)
    G = q.shape[2] // k.shape[2]
    dk, dv = fa.attention_bwd_dkdv_partial_plain(q, k, v, o, lse, do,
                                                 S * G, S * G + 64, **kw)
    assert not dk.any() and not dv.any()


def test_bwd_plan_chooses_route_and_splits_from_shapes():
    """f32 takes the CUDA cores unsplit; bf16 the tensor cores, split
    where the dK/dV grid is short of the card: the MQA training shapes
    (recurrentgemma 16/1 and paligemma 8/1 at head_dim 256), not qwen's
    or seamless's 16/16 of 64.  Ints and a dtype in, no tensor."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert list(inspect.signature(fa.bwd_plan).parameters) == [
        "B", "S", "T", "Hq", "Hkv", "D", "dtype"]
    for shape in ((8, 128, 128, 16, 1, 256), (8, 384, 384, 8, 1, 256),
                  (1, 4096, 4096, 16, 1, 256), (8, 128, 128, 16, 16, 64)):
        assert fa.bwd_plan(*shape, f32) == ("simt", 1)
    for shape in ((8, 128, 128, 16, 1, 256), (8, 384, 384, 8, 1, 256),
                  (1, 4096, 4096, 16, 1, 256)):
        path, n_split = fa.bwd_plan(*shape, bf16)
        assert path == "tc" and 1 < n_split <= fa.MAX_SPLITS, shape
    for shape in ((8, 128, 128, 16, 16, 64), (4, 1024, 1024, 16, 16, 64),
                  (8, 512, 512, 16, 16, 64), (8, 128, 512, 16, 16, 64),
                  (8, 128, 128, 24, 8, 64)):
        assert fa.bwd_plan(*shape, bf16) == ("tc", 1), shape
    # about one dK/dV block an SM, never fewer than MIN_SPLIT_TILES row
    # tiles a split
    B_, S_, T_, Hq, Hkv, D = 8, 128, 128, 16, 1, 256
    blocks = -(-T_ // fa.DKDV_KEYS) * Hkv * B_
    _, n_split = fa.bwd_plan(B_, S_, T_, Hq, Hkv, D, bf16)
    assert (n_split - 1) * blocks < fa.SMS <= n_split * blocks
    _, n_split = fa.bwd_plan(1, 3, 3, 16, 1, 256, bf16)   # one row tile
    assert n_split == 1
