"""The port's ``ShardedSampler`` against the JAX package's on the same
arguments: the same shard indices, pad masks and state for every
``(num_samples, num_shards, shard_index, shuffle, seed, epoch)`` of a grid
that includes a pad larger than the set (1 sample over 3 shards). Exact
equality: both are numpy over the same Philox stream."""
import numpy as np
import pytest

from pytorch_distributed_template_tpu.data.sampler import (
    ShardedSampler as JSampler, epoch_permutation as jperm,
)

from pytorch_distributed_template_tpu_torch.data.sampler import (
    ShardedSampler as TSampler, epoch_permutation as tperm,
)

GRID = [(1, 3), (7, 2), (10, 4), (64, 8), (250, 2), (449, 2), (5, 5)]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n, shards", GRID)
def test_shards_match_jax(n, shards, shuffle):
    seen = []
    for seed in (0, 3):
        for rank in range(shards):
            j = JSampler(n, num_shards=shards, shard_index=rank,
                         shuffle=shuffle, seed=seed)
            t = TSampler(n, num_shards=shards, shard_index=rank,
                         shuffle=shuffle, seed=seed)
            assert len(t) == len(j)
            for epoch in (0, 1, 5):
                j.set_epoch(epoch)
                t.set_epoch(epoch)
                assert np.array_equal(t.indices(), j.indices())
                assert np.array_equal(t.pad_mask(), j.pad_mask())
                assert t.state() == j.state()
                assert list(t) == list(j)
                if seed == 0 and epoch == 1:
                    seen.append(t.indices()[t.pad_mask()])
    # the real indices of all shards cover the set exactly once
    assert sorted(np.concatenate(seen).tolist()) == list(range(n))


def test_permutation_and_argument_checks_match_jax():
    assert np.array_equal(tperm(4, 2, 33), jperm(4, 2, 33))
    for args in ((0, 1, 0), (5, 2, 2), (5, 2, -1)):
        with pytest.raises(ValueError):
            JSampler(*args)
        with pytest.raises(ValueError):
            TSampler(*args)


def test_defaults_come_from_the_process_group():
    s = TSampler(10)
    assert (s.num_shards, s.shard_index) == (1, 0)
    assert np.array_equal(s.pad_mask(), np.ones(10, bool))
