"""The port's ``ops/augment.py`` against the JAX package's.

The applies are fed JAX's own draws, recomputed here from its key with
``jax.random`` exactly as the JAX functions draw them, and must give the
JAX functions' output exactly (``array_equal``, every dtype the loaders
give: float32 images and uint8 shards), each transform alone and the
composition of ``build_augment`` (transform ``i`` keyed by ``fold_in(key,
i)``). Unknown keys raise in both. The port's host draws for the global
batch, sliced to a data shard's rows ``index::count``, equal the shard's
own draw, and applying them to the shard's rows gives those rows of the
whole batch's result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_template_tpu.ops import augment as jaug
from pytorch_distributed_template_tpu_torch.ops import augment as taug

B, H, W, C = 6, 12, 10, 3


def _x(dtype=np.float32):
    rng = np.random.default_rng(0)
    if dtype == np.uint8:
        return rng.integers(0, 256, size=(B, H, W, C)).astype(np.uint8)
    return rng.normal(size=(B, H, W, C)).astype(np.float32)


def _jax_flip_draw(key):
    return np.asarray(jax.random.bernoulli(key, 0.5, (B,)))


def _jax_crop_draw(key, pad):
    ky, kx = jax.random.split(key)
    return np.stack([np.asarray(jax.random.randint(ky, (B,), 0, 2 * pad + 1)),
                     np.asarray(jax.random.randint(kx, (B,), 0,
                                                   2 * pad + 1))])


def _jax_cutout_draw(key, size):
    ky, kx = jax.random.split(key)
    return np.stack([
        np.asarray(jax.random.randint(ky, (B,), 0, max(H - size + 1, 1))),
        np.asarray(jax.random.randint(kx, (B,), 0, max(W - size + 1, 1)))])


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("seed", [0, 3])
def test_flip_on_jax_draws_is_exact(dtype, seed):
    key = jax.random.PRNGKey(seed)
    x = _x(dtype)
    want = np.asarray(jaug.random_flip(key, jnp.asarray(x)))
    flip = torch.from_numpy(_jax_flip_draw(key))
    got = taug.apply_flip(torch.from_numpy(x), flip).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("pad", [1, 4])
def test_crop_on_jax_draws_is_exact(dtype, pad):
    key = jax.random.PRNGKey(11)
    x = _x(dtype)
    want = np.asarray(jaug.random_crop(key, jnp.asarray(x), pad))
    offsets = torch.from_numpy(_jax_crop_draw(key, pad))
    got = taug.apply_crop(torch.from_numpy(x), offsets, pad).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [4, 12])
def test_cutout_on_jax_draws_is_exact(size):
    key = jax.random.PRNGKey(5)
    x = _x()
    want = np.asarray(jaug.random_cutout(key, jnp.asarray(x), size))
    corners = torch.from_numpy(_jax_cutout_draw(key, size))
    got = taug.apply_cutout(torch.from_numpy(x), corners, size).numpy()
    np.testing.assert_array_equal(got, want)
    zeroed = (got == 0).all(axis=-1).sum(axis=(1, 2))
    assert (zeroed == min(size, H) * min(size, W)).all()


@pytest.mark.parametrize("cfg", [
    {"flip": True, "crop_padding": 4},
    {"flip": True, "crop_padding": 2, "cutout": 5},
    {"crop_padding": 3, "cutout": 4},
    {"cutout": 6},
])
def test_composition_on_jax_draws_is_exact(cfg):
    key = jax.random.PRNGKey(7)
    x = _x()
    want = np.asarray(jaug.build_augment(cfg)(key, jnp.asarray(x)))
    aug = taug.build_augment(cfg)
    draws = {}
    for i, name in enumerate(aug.steps):
        k = jax.random.fold_in(key, i)
        draws[name] = torch.from_numpy(
            _jax_flip_draw(k) if name == "flip" else
            _jax_crop_draw(k, cfg["crop_padding"]) if name == "crop" else
            _jax_cutout_draw(k, cfg["cutout"]))
    got = aug.apply(torch.from_numpy(x), draws).numpy()
    np.testing.assert_array_equal(got, want)


def test_unknown_keys_raise_in_both_and_empty_is_none():
    bad = {"flip": True, "crop_pading": 4}
    with pytest.raises(ValueError, match="crop_pading"):
        jaug.build_augment(bad)
    with pytest.raises(ValueError, match="crop_pading"):
        taug.build_augment(bad)
    for cfg in (None, {}, {"flip": False, "crop_padding": 0}):
        assert taug.build_augment(cfg) is None
        assert jaug.build_augment(cfg) is None


@pytest.mark.parametrize("count", [2, 3])
def test_global_draw_sliced_per_shard(count):
    """A data shard's draws are rows ``index::count`` of the global
    batch's, and its augmented rows are those rows of the whole batch's
    result (the shard holds the global rows ``index::count``)."""
    aug = taug.build_augment({"flip": True, "crop_padding": 2, "cutout": 3})
    x = torch.from_numpy(_x())
    whole = aug(12345, x)
    full = aug.draw(12345, B, H, W)
    for index in range(count):
        part = aug.draw(12345, B, H, W, shard=(index, count))
        for name in aug.steps:
            np.testing.assert_array_equal(part[name],
                                          full[name][..., index::count])
        rows = x[index::count]
        got = aug(12345, rows, shard=(index, count))
        np.testing.assert_array_equal(got.numpy(),
                                      whole[index::count].numpy())


def test_draws_are_a_pure_function_of_the_seed():
    aug = taug.build_augment({"flip": True, "crop_padding": 4})
    a, b = aug.draw(9, 64, 32, 32), aug.draw(9, 64, 32, 32)
    c = aug.draw(10, 64, 32, 32)
    for name in aug.steps:
        np.testing.assert_array_equal(a[name], b[name])
    assert any(not np.array_equal(a[n], c[n]) for n in aug.steps)
    assert 0 < a["flip"].mean() < 1
    assert a["crop"].min() >= 0 and a["crop"].max() <= 8
