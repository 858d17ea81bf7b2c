"""The port's sequence-parallel attention (ops/attention.py) against the JAX
package's ``ring_attention`` and ``ulysses_attention`` on the fake CPU
devices, one process.

The same numpy inputs (seeded) go through JAX's function under
``shard_map`` on a ``{"seq": S}`` mesh of S CPU devices (its flash blocks
run as the JAX package's own tests run them on the CPU) and through the
port's one-process path (``ring_attention_shards``,
``ulysses_attention_shards``: S shards in a list, the per-step work of the
process-group path with the exchange a list rotation). Covered: the
contiguous ring with einsum and flash blocks, causal and not; the windowed
causal ring's banded-skip schedule (windows hitting the diagonal-only,
edge and full-then-edge tiers); the zigzag ring at S 2 and 4; compact GQA
K/V (4 query heads over 2); Ulysses with a window. Tolerances (float32 both
sides): outputs atol/rtol 1e-5, the gradients of q, k and v for a random
cotangent 1e-4. Then ``zigzag_perm`` and ``_ring_steps_needed`` equal
JAX's over a grid, the ring's flash blocks go through
``flash_attention_lse`` (no block bypasses it), and the cases where JAX
falls back to dense attention or refuses raise by name here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.ops import attention as jatt
from pytorch_distributed_template_tpu.parallel.mesh import build_mesh

from pytorch_distributed_template_tpu_torch.ops import attention as tatt
from pytorch_distributed_template_tpu_torch.ops import flash as tflash

from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401

B, T, H, KVH, D = 2, 32, 4, 2, 8
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

# (S, layout, impl, causal, window, kv heads): at T 32 and S 4 the shards
# hold 8 positions, so window 3 runs the diagonal and one edge block, 12
# two edge blocks, 20 one full block then edge blocks
CASES = {
    "contig-einsum-causal": (4, "contig", "ring", True, 0, KVH),
    "contig-einsum-full": (4, "contig", "ring", False, 0, H),
    "contig-flash-causal": (4, "contig", "ring_flash", True, 0, H),
    "contig-flash-full-gqa": (4, "contig", "ring_flash", False, 0, KVH),
    "band-flash-edge": (4, "contig", "ring_flash", True, 3, KVH),
    "band-flash-2edges": (4, "contig", "ring_flash", True, 12, KVH),
    "band-flash-full-edge": (4, "contig", "ring_flash", True, 20, KVH),
    "band-einsum": (4, "contig", "ring", True, 12, KVH),
    "zigzag-einsum-s2": (2, "zigzag", "ring", True, 0, H),
    "zigzag-einsum-s4-gqa": (4, "zigzag", "ring", True, 0, KVH),
    "zigzag-flash-s4-gqa": (4, "zigzag", "ring_flash", True, 0, KVH),
    "ulysses-window-gqa": (2, "contig", "ulysses", True, 10, KVH),
    "ulysses-flash-window-gqa": (2, "contig", "ulysses_flash", True, 10,
                                 KVH),
}


def _inputs(seed, kvh, layout, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, kvh, D)).astype(np.float32)
    v = rng.standard_normal((B, T, kvh, D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    perm = (jatt.zigzag_perm(T, s) if layout == "zigzag"
            else np.arange(T))
    return [x[:, perm] for x in (q, k, v, g)]


def _jax(s, layout, impl, causal, window, q, k, v, g):
    mesh = build_mesh({"seq": s}, jax.devices()[:s])

    def fn(q, k, v):
        if impl.startswith("ulysses"):
            return jatt.ulysses_attention(
                q, k, v, mesh, causal=causal, window=window,
                inner="flash" if impl == "ulysses_flash" else "xla")
        return jatt.ring_attention(
            q, k, v, mesh, causal=causal, layout=layout, window=window,
            block_impl="flash" if impl == "ring_flash" else "einsum")

    out, vjp = jax.vjp(jax.jit(fn), *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _port(s, layout, impl, causal, window, q, k, v, g):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    shards = [list(x.chunk(s, dim=1)) for x in leaves]
    if impl.startswith("ulysses"):
        outs = tatt.ulysses_attention_shards(
            *shards, causal=causal, window=window,
            inner="flash" if impl == "ulysses_flash" else "xla")
    else:
        outs = tatt.ring_attention_shards(
            *shards, causal=causal, layout=layout, window=window,
            block_impl="flash" if impl == "ring_flash" else "einsum")
    out = torch.cat(outs, dim=1)
    out.backward(torch.tensor(g))
    return [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax_forward_and_gradients(case):
    s, layout, impl, causal, window, kvh = CASES[case]
    q, k, v, g = _inputs(sorted(CASES).index(case), kvh, layout, s)
    want = _jax(s, layout, impl, causal, window, q, k, v, g)
    got = _port(s, layout, impl, causal, window, q, k, v, g)
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_zigzag_perm_and_ring_steps_match_jax():
    for s in (1, 2, 3, 4, 8):
        for t in (2 * s, 8 * s, 24 * s):
            np.testing.assert_array_equal(tatt.zigzag_perm(t, s),
                                          jatt.zigzag_perm(t, s))
    with pytest.raises(ValueError, match="divisible"):
        tatt.zigzag_perm(12, 4)
    for tl in (1, 8, 16, 512, 4096):
        for s in (1, 2, 4, 8):
            for w in (0, 1, 3, 8, 16, 17, 100, 2048, 10 ** 6):
                assert tatt._ring_steps_needed(tl, s, w) == \
                    jatt._ring_steps_needed(tl, s, w), (tl, s, w)


@pytest.mark.parametrize("layout", ["contig", "zigzag"])
def test_seq_positions_cover_the_row_once(layout):
    s, t = 4, 32
    parts = [tatt.seq_positions(t, s, i, layout) for i in range(s)]
    np.testing.assert_array_equal(np.sort(np.concatenate(parts)),
                                  np.arange(t))
    want = (jatt.zigzag_perm(t, s) if layout == "zigzag" else np.arange(t))
    np.testing.assert_array_equal(np.concatenate(parts), want)


def test_flash_blocks_go_through_flash_attention_lse(monkeypatch):
    """Every block of the flash bodies is a ``flash_attention_lse`` call
    (the kernels' wrapper on the card): the zigzag ring's 3 + 2 (S - 1)
    per shard, the contiguous ring's S - 1 + 1 per shard, the banded ring's
    one diagonal block per shard (its edge block is einsum)."""
    calls = []
    real = tflash.flash_attention_lse

    def counted(*args, **kw):
        calls.append(kw.get("causal"))
        return real(*args, **kw)

    monkeypatch.setattr(tflash, "flash_attention_lse", counted)
    s = 4
    for layout, window, want in (("zigzag", 0, s * (3 + 2 * (s - 1))),
                                 ("contig", 0, s * s),
                                 ("contig", 8, s)):
        q, k, v, _ = (torch.tensor(x) for x in
                      _inputs(0, KVH, layout, s))
        calls.clear()
        tatt.ring_attention_shards(
            *(list(x.chunk(s, dim=1)) for x in (q, k, v)), causal=True,
            layout=layout, block_impl="flash", window=window)
        assert len(calls) == want, (layout, window, len(calls))


def test_refusals_name_their_constraint():
    q = torch.zeros((1, 16, 4, 8))
    kv = torch.zeros((1, 16, 2, 8))
    shards = [list(x.chunk(4, dim=1)) for x in (q, kv, kv)]
    with pytest.raises(ValueError, match="window"):
        tatt.ring_attention_shards(*shards, layout="zigzag", window=8)
    with pytest.raises(ValueError, match="causal=True"):
        tatt.ring_attention_shards(*shards, causal=False, layout="zigzag")
    odd = [list(x.chunk(4, dim=1)) for x in (torch.zeros((1, 12, 4, 8)),
                                             torch.zeros((1, 12, 2, 8)),
                                             torch.zeros((1, 12, 2, 8)))]
    with pytest.raises(ValueError, match="2\\*seq"):
        tatt.ring_attention_shards(*odd, layout="zigzag")
    with pytest.raises(ValueError, match="block_impl"):
        tatt.ring_attention_shards(*shards, block_impl="pallas")
    three = [list(x.chunk(8, dim=1)) for x in (q, kv, kv)]
    with pytest.raises(ValueError, match="query heads"):
        tatt.ulysses_attention_shards(*three)
    with pytest.raises(ValueError, match="not divisible by the seq axis"):
        tatt.seq_positions(30, 4, 0)

    class Seq4:
        def axis_size(self, name):
            return 4

        def axis_index(self, name):
            return 1

    with pytest.raises(ValueError, match="sequence-parallel attn_impl"):
        tatt.seq_plan(Seq4(), "flash", "natural", 32, "cpu")
    with pytest.raises(ValueError, match="not divisible by the seq axis"):
        tatt.seq_plan(Seq4(), "ring_flash", "natural", 30, "cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        tatt.sequence_attention(q, kv, kv, "ring", None)
    # zigzag needs 2 S chunks: 36 tokens on 4 shards ride the contig ring,
    # as the JAX models skip the permutation then
    shard, layout = tatt.seq_plan(Seq4(), "ring_flash", "zigzag", 36, "cpu")
    assert layout == "contig" and shard.positions.tolist() == list(
        range(9, 18))


def test_one_shard_is_jax_dense():
    """A seq axis of 1 computes JAX's dense function (flash for the
    ``*_flash`` impls, the einsum attention otherwise)."""
    q, k, v, _ = _inputs(3, KVH, "contig", 1)
    want = np.asarray(jatt.multihead_attention(
        jnp.asarray(q), jnp.repeat(k, H // KVH, 2),
        jnp.repeat(v, H // KVH, 2), causal=True, window=5))
    for impl in tatt.SP_IMPLS:
        got = tatt.sequence_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v), impl,
            _one_seq_mesh(), window=5)
        np.testing.assert_allclose(got.numpy(), want, err_msg=impl,
                                   **FWD_TOL)


def _one_seq_mesh():
    from pytorch_distributed_template_tpu_torch.parallel.mesh import Mesh

    return Mesh({"data": 1, "seq": 1})
