"""The port's paged attention (plain version of kernel B4, CPU), int8 KV
quantization and pool converters against the JAX package.

Same numpy inputs (seeded) go to the JAX ``paged_attention`` (its Pallas
kernel in interpret mode, and its plain ``paged_attention_ref``) and to the
port's ``paged_attention``. Only VALID query lanes (``i >= pad_lens[b]``)
are compared: invalid lanes are garbage by contract on both sides.
Tolerance atol 1e-5 (float32; the sides differ only in summation order).
``quantize_kv`` must give the JAX package's bytes exactly, and the pool
converters must round-trip exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.models import quant as jquant
from pytorch_distributed_template_tpu.ops import flash as jflash
from pytorch_distributed_template_tpu_torch.models import convert
from pytorch_distributed_template_tpu_torch.models import quant as tquant
from pytorch_distributed_template_tpu_torch.ops import attention as tattn
from pytorch_distributed_template_tpu_torch.ops import flash as tflash

ATOL = 1e-5


def _flat_case(seed, b, t, hq, kvh, d, bt, pool, lens):
    """Random pools and ragged, non-contiguous block tables (the pattern
    of tests/test_kvcache.py::_paged_case): row ``i`` holds ``lens[i]``
    tokens through pages drawn from a shuffled pool order, unused table
    lanes -1, page 0 never mapped."""
    rng = np.random.default_rng(seed)
    nb = max(-(-int(n) // bt) for n in lens)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k_pool = rng.standard_normal((pool, bt, kvh, d)).astype(np.float32)
    v_pool = rng.standard_normal((pool, bt, kvh, d)).astype(np.float32)
    avail = list(range(1, pool))
    rng.shuffle(avail)
    tables = np.full((b, nb), -1, np.int32)
    it = iter(avail)
    for i, n in enumerate(lens):
        for j in range(-(-int(n) // bt)):
            tables[i, j] = next(it)
    starts = np.asarray([int(n) - t for n in lens], np.int32)
    return q, k_pool, v_pool, tables, starts


def _ring_case(seed, n_total, t, window, bt, kvh=2, hq=4, d=32,
               quant=False):
    """One row laid contiguously through a ring of ``window//bt + 1 + 2``
    pages, newer blocks overwriting older slots (the pattern of
    tests/test_longctx.py::_ring_case). ``quant`` stores int8 pages and
    f32 scale leaves."""
    rng = np.random.default_rng(seed)
    nb = window // bt + 1 + 2
    pages = nb + 2
    q = rng.standard_normal((1, t, hq, d)).astype(np.float32)
    k_full = rng.standard_normal((n_total, kvh, d)).astype(np.float32)
    v_full = rng.standard_normal((n_total, kvh, d)).astype(np.float32)
    kdt = np.int8 if quant else np.float32
    k_pool = np.zeros((pages, bt, kvh, d), kdt)
    v_pool = np.zeros((pages, bt, kvh, d), kdt)
    kps = vps = None
    if quant:
        kq, ks = (np.asarray(a) for a in jquant.quantize_kv(k_full))
        vq, vs = (np.asarray(a) for a in jquant.quantize_kv(v_full))
        k_full, v_full = kq, vq
        kps = np.ones((pages, bt, kvh), np.float32)
        vps = np.ones((pages, bt, kvh), np.float32)
    tables = np.full((1, nb), -1, np.int32)
    for j in range(-(-n_total // bt)):
        page = 1 + j % nb
        tables[0, j % nb] = page
        lo, hi = j * bt, min((j + 1) * bt, n_total)
        k_pool[page, :hi - lo] = k_full[lo:hi]
        v_pool[page, :hi - lo] = v_full[lo:hi]
        if quant:
            kps[page, :hi - lo] = ks[lo:hi]
            vps[page, :hi - lo] = vs[lo:hi]
    starts = np.asarray([n_total - t], np.int32)
    return q, k_pool, v_pool, tables, starts, kps, vps


def _both(q, kp, vp, tables, starts, pads, window=0, ks=None, vs=None):
    """(JAX Pallas interpret, JAX plain, port) outputs as numpy."""
    jargs = dict(window=window,
                 k_scale=None if ks is None else jnp.asarray(ks),
                 v_scale=None if vs is None else jnp.asarray(vs))
    jin = [jnp.asarray(x) for x in (q, kp, vp, tables, starts, pads)]
    pal = jflash.paged_attention(*jin, impl="pallas", interpret=True,
                                 **jargs)
    ref = jflash.paged_attention_ref(*jin, **jargs)
    tin = [torch.from_numpy(np.array(x))
           for x in (q, kp, vp, tables, starts, pads)]
    port = tattn.paged_gqa_attention(
        *tin, window=window,
        k_scale=None if ks is None else torch.from_numpy(np.array(ks)),
        v_scale=None if vs is None else torch.from_numpy(np.array(vs)))
    assert port.shape == q.shape and port.dtype == torch.float32
    return np.asarray(pal), np.asarray(ref), port.numpy()


def _assert_valid_lanes(got, want, pads):
    for b, p in enumerate(pads):
        np.testing.assert_allclose(got[b, p:], want[b, p:], atol=ATOL)


@pytest.mark.parametrize("t,bt,lens", [
    (1, 8, [8, 24]),            # decode step, block-aligned rows
    (1, 8, [13, 21]),           # ragged last blocks
    (8, 8, [16, 29]),           # suffix window crossing a block edge
    (4, 16, [16, 61]),          # one-block vs many-block rows
])
def test_paged_flat_matches_jax(t, bt, lens):
    q, kp, vp, tables, starts = _flat_case(
        hash((t, bt, tuple(lens))) % 1000, len(lens), t, 4, 2, 32, bt, 16,
        lens)
    pads = np.zeros((len(lens),), np.int32)
    pal, ref, port = _both(q, kp, vp, tables, starts, pads)
    _assert_valid_lanes(port, pal, pads)
    _assert_valid_lanes(port, ref, pads)


def test_paged_pad_lanes_match_jax_and_dense():
    """Leading invalid lanes (a right-aligned suffix feed): valid lanes
    equal the JAX kernel, and on a contiguously laid pool they equal
    dense causal grouped-query attention (tests/test_kvcache.py:407)."""
    rng = np.random.default_rng(11)
    b, t, hq, kvh, d, bt, L = 2, 8, 4, 2, 32, 8, 32
    nb = L // bt
    k_all = rng.standard_normal((b, L, kvh, d)).astype(np.float32)
    v_all = rng.standard_normal((b, L, kvh, d)).astype(np.float32)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    zero = np.zeros((1, bt, kvh, d), np.float32)
    kp = np.concatenate([zero] + [k_all[i].reshape(nb, bt, kvh, d)
                                  for i in range(b)])
    vp = np.concatenate([zero] + [v_all[i].reshape(nb, bt, kvh, d)
                                  for i in range(b)])
    tables = np.asarray([[1 + i * nb + j for j in range(nb)]
                         for i in range(b)], np.int32)
    starts = np.asarray([L - t] * b, np.int32)
    pads = np.asarray([0, 3], np.int32)
    pal, ref, port = _both(q, kp, vp, tables, starts, pads)
    _assert_valid_lanes(port, pal, pads)
    _assert_valid_lanes(port, ref, pads)
    q_pos = (L - t) + np.arange(t)
    mask = torch.from_numpy(np.arange(L)[None, :] <= q_pos[:, None])
    dense = tattn.grouped_query_attention(
        torch.from_numpy(q), torch.from_numpy(k_all),
        torch.from_numpy(v_all), mask=mask.expand(b, 1, t, L)).numpy()
    _assert_valid_lanes(port, dense, pads)


@pytest.mark.parametrize("n_total,t,window,bt", [
    (24, 1, 16, 8),          # in-span decode step (no wrap yet)
    (90, 1, 16, 8),          # deep wrap, decode step
    (90, 8, 16, 8),          # wrapped multi-lane suffix window
    (70, 4, 32, 8),          # wider band
])
def test_paged_ring_matches_jax(n_total, t, window, bt):
    q, kp, vp, tables, starts, _, _ = _ring_case(
        hash((n_total, t, window, bt)) % 997, n_total, t, window, bt)
    pads = np.zeros((1,), np.int32)
    pal, ref, port = _both(q, kp, vp, tables, starts, pads, window=window)
    _assert_valid_lanes(port, pal, pads)
    _assert_valid_lanes(port, ref, pads)


def test_paged_ring_int8_epilogue_matches_jax():
    """The dequant epilogue composes with the ring mapping
    (tests/test_longctx.py:360)."""
    q, kp, vp, tables, starts, ks, vs = _ring_case(13, 70, 4, 32, 8,
                                                   quant=True)
    pads = np.zeros((1,), np.int32)
    pal, ref, port = _both(q, kp, vp, tables, starts, pads, window=32,
                           ks=ks, vs=vs)
    _assert_valid_lanes(port, pal, pads)
    _assert_valid_lanes(port, ref, pads)


def test_paged_flat_int8_with_pad_lanes_matches_jax():
    q, kp, vp, tables, starts = _flat_case(5, 2, 8, 4, 2, 16, 8, 12,
                                           [29, 40])
    kq, ks = (np.asarray(a) for a in jquant.quantize_kv(kp))
    vq, vs = (np.asarray(a) for a in jquant.quantize_kv(vp))
    pads = np.asarray([2, 0], np.int32)
    pal, ref, port = _both(q, kq, vq, tables, starts, pads, ks=ks, vs=vs)
    _assert_valid_lanes(port, pal, pads)
    _assert_valid_lanes(port, ref, pads)


def test_quantize_kv_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 2, 32)) * 4).astype(np.float32)
    x[1, 2, 0] = 0.0                              # all-zero row: scale 1
    x[0, 0, 1, :4] = [127.0, -127.0, 0.5, -0.5]   # round-half-even ties
    jq, js = (np.asarray(a) for a in jquant.quantize_kv(x))
    tq, ts = tquant.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  js.view(np.int32))
    assert ts.numpy()[1, 2, 0] == 1.0
    back = tquant.dequantize_kv(tq, ts, torch.float32).numpy()
    jback = np.asarray(jquant.dequantize_kv(jq, js, jnp.float32))
    np.testing.assert_array_equal(back, jback)


def test_pool_converters_round_trip_exactly():
    """flax cache leaves (``layers_i/self_attn/cached_key`` pool pages)
    -> the port's paged cache -> flax leaves, bytes unchanged, for f32
    and for int8 pages with their scale leaves."""
    rng = np.random.default_rng(7)
    for quant in (False, True):
        tree = {}
        for i in range(2):
            attn = {}
            for name in ("cached_key", "cached_value"):
                arr = rng.standard_normal((6, 8, 2, 16)).astype(np.float32)
                if quant:
                    arr = (arr * 40).astype(np.int8)
                    attn[name + "_scale"] = rng.random(
                        (6, 8, 2)).astype(np.float32)
                attn[name] = arr
            tree[f"layers_{i}"] = {"self_attn": attn}
        pool = convert.pool_from_flax(tree)
        assert len(pool.layers) == 2
        assert (pool.layers[0].k_scale is not None) == quant
        np.testing.assert_array_equal(
            pool.layers[1].v.numpy(),
            tree["layers_1"]["self_attn"]["cached_value"])
        back = convert.flax_from_pool(pool)
        for i in range(2):
            for name, arr in tree[f"layers_{i}"]["self_attn"].items():
                got = back[f"layers_{i}"]["self_attn"][name]
                assert got.dtype == arr.dtype, name
                np.testing.assert_array_equal(got, arr)


def test_paged_bound_counts_visible_keys_and_pages():
    """The bound counts this call's visible keys and distinct pages:
    one decode lane at position 20 over a flat table of 3 pages (bt 8)
    sees 21 keys on 3 pages."""
    q = torch.zeros((1, 1, 4, 64))
    pool = torch.zeros((8, 8, 2, 64))
    tables = torch.tensor([[3, 5, 7, -1]], dtype=torch.int32)
    starts = torch.tensor([20], dtype=torch.int32)
    pads = torch.zeros((1,), dtype=torch.int32)
    secs, by = tflash.paged_bound_seconds(q, pool, tables, starts, pads,
                                          0, False, 1.0, 1e30)
    assert by == "operations" and secs == 4 * 4 * 64 * 21
    secs, by = tflash.paged_bound_seconds(q, pool, tables, starts, pads,
                                          0, False, 1e30, 1.0)
    assert by == "bytes"
    assert secs == 3 * 2 * 8 * 2 * 64 * 4 + 2 * q.numel() * 4


@pytest.mark.parametrize("dtype,bt,rows,arm", [
    (torch.bfloat16, 32, 4, "decode"),        # Mistral decode: T 1 x 4
    (torch.bfloat16, 32, 16, "decode"),
    (torch.bfloat16, 32, 17, "wgmma"),
    (torch.bfloat16, 16, 256, "wgmma"),       # 64-lane admission feed
    (torch.bfloat16, 32, 2048, "wgmma"),      # 512-lane prefill chunk
    (torch.bfloat16, 32, 32, "wgmma"),        # group 32 decode
    (torch.bfloat16, 8, 4, "cuda_cores"),     # 8-token pages
    (torch.bfloat16, 8, 2048, "cuda_cores"),
    (torch.float32, 32, 4, "cuda_cores"),     # f32 queries
    (torch.float32, 16, 2048, "cuda_cores"),
])
def test_paged_arm_choice(dtype, bt, rows, arm):
    """B4's arm is a function of (query dtype, page tokens, rows per kv
    head): bf16 over 16/32-token pages takes the decode arm up to one
    block's 16 rows and the wgmma arm above; the rest the CUDA cores."""
    assert tflash.paged_arm(dtype, bt, rows) == arm


@pytest.mark.parametrize("arm,group,lanes", [
    ("wgmma", 4, 32), ("wgmma", 1, 128), ("wgmma", 8, 16),
    ("wgmma", 32, 4), ("wgmma", 3, 42), ("decode", 4, 4),
    ("decode", 1, 16), ("decode", 16, 1), ("decode", 32, 0),
    ("cuda_cores", 4, 8), ("cuda_cores", 32, 1),
])
def test_paged_lanes_per_block(arm, group, lanes):
    """Lanes per block (or wgmma item): the arm's rows (128 / 16 / 32)
    over the query heads of a kv head; 0 = the group does not fit."""
    assert tflash.paged_lanes(arm, group) == lanes


@pytest.mark.parametrize("arm,units,nb,sms,splits", [
    ("wgmma", 16 * 8, 145, 132, 1),     # 1 x 512 chunk: 128 items
    ("wgmma", 2 * 8 * 8, 145, 132, 1),  # 8 x 64 feed: 128 items
    ("wgmma", 66, 145, 132, 1),
    ("wgmma", 65, 145, 132, 2),
    ("wgmma", 8, 145, 132, 16),         # one 32-lane admission
    ("wgmma", 8, 40, 132, 5),           # at least 8 slots per split
    ("decode", 8 * 8, 145, 132, 4),     # 8-row decode: ~2 blocks per SM
    ("decode", 132, 145, 132, 1),
    ("decode", 131, 145, 132, 2),
    ("decode", 8, 145, 132, 16),
    ("cuda_cores", 8 * 8, 145, 132, 8),  # ~4 blocks per SM
    ("cuda_cores", 100, 12, 132, 1),
])
def test_paged_splits(arm, units, nb, sms, splits):
    assert tflash.paged_splits(arm, units, nb, sms) == splits
