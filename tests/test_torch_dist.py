"""The port's ``parallel/dist.py`` and ``parallel/mesh.py`` in one
process: every helper degrades to the identity without a process group
(as JAX ``tests/test_dist.py`` pins for the JAX one), ``initialize`` joins
nothing without a launcher's environment, and the config's mesh resolves
to the data axis over the ranks while every other axis refuses by name."""
import pytest

from pytorch_distributed_template_tpu.parallel.mesh import (
    resolve_axis_sizes as jresolve,
)

from pytorch_distributed_template_tpu_torch.parallel import dist, mesh


def test_introspection_without_a_group():
    assert dist.process_index() == 0
    assert dist.process_count() == 1
    assert dist.is_main_process()
    assert not dist.in_group()


def test_collectives_degrade_to_the_identity():
    import torch

    dist.synchronize()
    obj = {"count": 3, "arr": [1, 2]}
    out = dist.all_gather_object(obj)
    assert out == [obj] and out[0] is obj
    assert dist.broadcast_object(obj) is obj
    t = torch.arange(3.0)
    assert dist.all_reduce_sum(t) is t and t.tolist() == [0.0, 1.0, 2.0]


def test_initialize_without_a_launcher_joins_nothing(monkeypatch):
    for var in dist.LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    assert not dist.launched()
    assert str(dist.initialize("cpu")) == "cpu"
    assert not dist.in_group()
    dist.shutdown()


@pytest.mark.parametrize("axes, n", [({"data": -1}, 1), ({"data": -1}, 4),
                                     ({"data": 2}, 2), (None, 3)])
def test_data_axis_resolves_as_in_jax(axes, n):
    cfg = {"mesh": {"axes": axes}} if axes else {}
    assert mesh.mesh_from_config(cfg, world_size=n) == {"data": n}
    assert mesh.resolve_axis_sizes(axes, n) == jresolve(axes, n)


def test_other_axes_refuse_and_bad_sizes_raise():
    # the expert axis runs beside data; beside seq it is A11d's remainder
    with pytest.raises(NotImplementedError, match="A11"):
        mesh.mesh_from_config({"mesh": {"axes": {"seq": 2, "expert": 2}}})
    with pytest.raises(ValueError, match="multiply"):
        mesh.mesh_from_config({"mesh": {"axes": {"data": 2}}}, world_size=1)
