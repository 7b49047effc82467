"""The tensor-core attention's split-K and row packing, on the CPU.

The bf16 kernel (``csrc/flash_attention.cu``, ``attn_fwd_tc``) splits the
key tiles of a block across blocks and merges the partials in
``attn_combine``; it packs the G = Hq / Hkv q heads of a kv head into the
rows of its tile.  Here their plain counterparts: every split of the
reference's ATTN_SWEEP (as prefill, chunk and (B,) decode), each split's
partial by ``attention_partial_plain`` and their merge by
``combine_plain``, must equal ``attention_plain`` at 1e-5 in f32; ``plan``
must choose from shapes alone; the packed-row map must be a bijection.
No JAX and no card needed."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as fa  # noqa: E402
from test_torch_attention import (ATTN_SWEEP, B, _chunk_case,  # noqa: E402
                                  _data, _decode_positions)

SPLIT_TOL = 1e-5


def _inputs(case, kind):
    """f32 (q, k, v, masks) of a sweep case as prefill, chunk or decode."""
    S, T, Hq, Hkv, D, causal, window, softcap, prefix, _ = case
    off = 0
    nb = B
    if kind == "chunk":
        S, off = _chunk_case(case)
    elif kind == "decode":
        S, off = 1, torch.from_numpy(_decode_positions(T))
        nb = len(off)
    q, k, v = (torch.from_numpy(a) for a in _data(
        7, (nb, S, Hq, D), (nb, T, Hkv, D), (nb, T, Hkv, D)))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off,
              prefix_len=prefix)
    return q, k, v, kw


def _split_combine(q, k, v, kw, ranges):
    parts = [fa.attention_partial_plain(q, k, v, lo, hi, **kw)
             for lo, hi in ranges]
    m, l, o = (torch.stack(x) for x in zip(*parts))
    return fa.combine_plain(m, l, o, q.dtype)


@pytest.mark.parametrize("bk", ["16", "kernel"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("kind", ["prefill", "chunk", "decode"])
@pytest.mark.parametrize("case", ATTN_SWEEP, ids=lambda c: "x".join(
    map(str, c[:5])) + f"w{c[6]}p{c[8]}c{int(c[5])}")
def test_split_then_combine_equals_plain(case, kind, n_split, bk):
    """Splits of [0, T) in whole tiles of the kernel's key tile and of 16
    keys (so that short sweeps get several non-empty splits): wholly
    masked splits (decode at position 0, past the causal edge, before a
    window), splits a window or a prefix crosses."""
    q, k, v, kw = _inputs(case, kind)
    T, D = k.shape[1], k.shape[3]
    G = q.shape[2] // k.shape[2]
    tile = 16 if bk == "16" else fa.key_tile(D, q.shape[1] * G)
    got = _split_combine(q, k, v, kw, fa.key_splits(0, T, tile, n_split))
    want = fa.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SPLIT_TOL,
                               atol=SPLIT_TOL)


def test_wholly_masked_partial_is_empty_and_merges_to_nothing():
    """A split no query can see has m = NEG_INF, l = 0, O = 0; alone it
    merges to zeros (the kernel's out = acc / max(l, 1e-30)), beside a
    live split it changes nothing."""
    q, k, v, kw = _inputs(ATTN_SWEEP[0], "decode")
    kw["q_offset"] = torch.zeros(len(q), dtype=torch.int32)  # key 0 only
    T = k.shape[1]
    m, l, o = fa.attention_partial_plain(q, k, v, 1, T, **kw)
    assert bool((m == fa.NEG_INF).all()) and not l.any() and not o.any()
    alone = fa.combine_plain(m[None], l[None], o[None], q.dtype)
    assert not alone.any()
    got = _split_combine(q, k, v, kw, [(0, 1), (1, T)])
    want = fa.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SPLIT_TOL,
                               atol=SPLIT_TOL)


def test_combine_casts_to_the_dtype():
    q, k, v, kw = _inputs(ATTN_SWEEP[6], "chunk")
    T = k.shape[1]
    got = _split_combine(q.bfloat16(), k.bfloat16(), v.bfloat16(), kw,
                         fa.key_splits(0, T, 32, 3))
    assert got.dtype == torch.bfloat16


# the main paths' shapes: (B, S, T, Hq, Hkv, D)
MAIN_SHAPES = {
    "qwen-prefill": (1, 384, 384, 16, 16, 64),
    "qwen-chunk": (1, 64, 1024, 16, 16, 64),
    "granite-chunk": (1, 64, 1024, 24, 8, 64),
    "qwen-decode-b8": (8, 1, 1024, 16, 16, 64),
    "qwen-decode-b4-t128": (4, 1, 128, 16, 16, 64),
    "granite-decode-b4-t1024": (4, 1, 1024, 24, 8, 64),
    "rg-prefill-s2600": (1, 2600, 2600, 16, 1, 256),
    "rg-prefill-s5": (1, 5, 5, 16, 1, 256),
    "rg-decode-b4-t3072": (4, 1, 3072, 16, 1, 256),
    "rg-decode-b4-t128": (4, 1, 128, 16, 1, 256),
}


@pytest.mark.parametrize("shape", MAIN_SHAPES.values(),
                         ids=MAIN_SHAPES.keys())
def test_plan_splits_within_the_key_tiles(shape):
    B_, S, T, Hq, Hkv, D = shape
    path, n = fa.plan(B_, S, T, Hq, Hkv, D, torch.bfloat16)
    rows = S * (Hq // Hkv)
    tiles = -(-T // fa.key_tile(D, rows))
    assert path == "tc" and 1 <= n <= min(tiles, fa.MAX_SPLITS)
    blocks = -(-rows // (fa.FRAG_ROWS if rows <= fa.FRAG_ROWS
                         else fa.ROWS)) * Hkv * B_
    if n > 1:                        # split only a grid short of the card
        assert 2 * blocks <= fa.SMS and blocks * n <= 2 * fa.SMS
        assert tiles // n >= fa.MIN_SPLIT_TILES
    assert fa.plan(B_, S, T, Hq, Hkv, D, torch.float32) == ("simt", 1)
    # the kernel's split of [0, T) into n covers it exactly once
    covered = np.zeros(T, np.int64)
    for lo, hi in fa.key_splits(0, T, fa.key_tile(D, rows), n):
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_plan_fills_the_card_where_the_grid_is_short():
    """Decode of recurrentgemma's 4 slots of 3072 is 4 blocks: split
    MAX_SPLITS ways; a 64-row qwen chunk (16 blocks) about 8; a long
    prefill not."""
    assert fa.plan(4, 1, 3072, 16, 1, 256, torch.bfloat16)[1] == \
        fa.MAX_SPLITS
    assert 6 <= fa.plan(1, 64, 1024, 16, 16, 64, torch.bfloat16)[1] <= 10
    assert fa.plan(1, 2600, 2600, 16, 1, 256, torch.bfloat16)[1] == 1


def test_plan_takes_shapes_only():
    """No tensor argument: the plan never reads a device value (decode's
    q_offset lives on the card; the models promise no host sync)."""
    params = inspect.signature(fa.plan).parameters
    assert list(params) == ["B", "S", "T", "Hq", "Hkv", "D", "dtype"]
    assert all(p.annotation in (int, "int") for n, p in params.items()
               if n != "dtype")


@pytest.mark.parametrize("n_split", [1, 2, 5, 40])
@pytest.mark.parametrize("span", [(0, 1), (0, 64), (5, 300), (100, 3072)])
def test_key_splits_cover_the_range_once(span, n_split):
    lo, hi = span
    bk = 32
    ranges = fa.key_splits(lo, hi, bk, n_split)
    assert len(ranges) == n_split
    assert all(a <= b for a, b in ranges)
    flat = [t for a, b in ranges for t in range(a, b)]
    assert flat == list(range(lo, hi))
    # whole tiles from lo, but for the ragged end
    assert all((a - lo) % bk == 0 for a, b in ranges if b > a)


@pytest.mark.parametrize("G", [1, 2, 3, 8, 16])
def test_packed_rows_are_a_bijection(G):
    """Row r of kv head hk's tiles is query r // G of q head hk*G + r % G;
    every (query, q head) has exactly one (kv head, row), and its kv head
    is the one GQA reads (h // G)."""
    S, Hkv = 7, 3
    Hq = G * Hkv
    seen = {}
    for hk in range(Hkv):
        for r in range(S * G):
            s, h = fa.packed_row(r, hk, G)
            assert 0 <= s < S and h // G == hk and s * G + h % G == r
            seen[(s, h)] = (hk, r)
    assert len(seen) == S * Hq


def test_forced_split_is_refused_for_f32():
    """f32 runs unsplit on the CUDA cores: a forced split raises before
    anything reaches a device."""
    q, k, v, kw = _inputs(ATTN_SWEEP[0], "prefill")
    with pytest.raises(ValueError, match="n_split 2 on the simt path"):
        fa._attention_cuda(q, k, v, n_split=2, **kw)
