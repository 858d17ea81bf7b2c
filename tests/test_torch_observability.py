"""The port's ``MetricTracker`` and ``TensorboardWriter`` against the JAX
package's: the same calls give the same running averages, and written
through both writers into two directories they give the same scalar tags
and values, read back with tensorboard's ``EventAccumulator``.
"""
import logging

import numpy as np
import pytest

from pytorch_distributed_template_tpu.observability import tb as jtb
from pytorch_distributed_template_tpu.observability import tracker as jtr

from pytorch_distributed_template_tpu_torch.observability import tb, tracker

LOG = logging.getLogger("test_torch_observability")


def _drive(writer_cls, tracker_cls, log_dir):
    """One short run of calls: train steps, a valid phase, text and an
    image, the way the trainer makes them."""
    w = writer_cls(log_dir, LOG, True)
    train = tracker_cls("loss", writer=w)
    valid = tracker_cls("loss", "accuracy", writer=w)
    for step in range(0, 12, 3):
        w.set_step(step)
        train.update("loss", 2.0 / (step + 1))
        w.add_scalar("lr", 1e-3 * (step + 1))
    w.set_step(12, mode="valid")
    valid.update("loss", 0.5)
    valid.update("accuracy", 0.75, n=4)
    w.set_step(13)
    w.add_image("input", np.linspace(0, 1, 4 * 8 * 3, dtype=np.float32)
                .reshape(4, 8, 3), dataformats="HWC")
    w.add_histogram("weights", np.arange(10.0))
    w.close()
    return w, train, valid


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    tags = acc.Tags()
    out = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
           for tag in tags["scalars"]}
    return out, set(tags["images"]), set(tags["histograms"])


def test_tb_writers_write_the_same_events(tmp_path):
    jw, _, _ = _drive(jtb.TensorboardWriter, jtr.MetricTracker,
                      tmp_path / "jax")
    tw, _, _ = _drive(tb.TensorboardWriter, tracker.MetricTracker,
                      tmp_path / "port")
    assert tw.selected_module == jw.selected_module != ""
    js, ji, jh = _scalars(tmp_path / "jax")
    ts, ti, th = _scalars(tmp_path / "port")
    assert set(ts) == set(js)
    assert {"loss/train", "lr/train", "loss/valid", "accuracy/valid",
            "steps_per_sec/train"} <= set(ts)
    for tag in js:
        if tag.startswith("steps_per_sec"):   # wall-clock derived
            assert [s for s, _ in ts[tag]] == [s for s, _ in js[tag]]
            continue
        np.testing.assert_allclose(ts[tag], js[tag], rtol=1e-7, err_msg=tag)
    assert ti == ji == {"input/train"}
    assert th == jh == {"weights"}


def test_trackers_agree():
    a, b = jtr.MetricTracker("loss"), tracker.MetricTracker("loss")
    for key, value, n in [("loss", 1.0, 1), ("loss", 3.0, 3),
                          ("acc", 0.5, 2), ("acc", 1.0, 1)]:
        a.update(key, value, n)
        b.update(key, value, n)
    assert a.result() == b.result()
    assert a.keys() == b.keys() == ["loss", "acc"]
    assert (a.count("loss"), a.avg("acc")) == (b.count("loss"), b.avg("acc"))
    a.reset()
    b.reset()
    assert a.result() == b.result() == {"loss": 0.0, "acc": 0.0}


@pytest.mark.parametrize("enabled", [False, True])
def test_writer_without_backend_warns_and_is_inert(enabled, tmp_path,
                                                   monkeypatch, caplog):
    monkeypatch.setattr(tb.TensorboardWriter, "TB_MODULES",
                        ("no_such_tb_backend",))
    with caplog.at_level(logging.WARNING):
        w = tb.TensorboardWriter(tmp_path, LOG, enabled)
    assert w.writer is None and w.selected_module == ""
    assert ("no backend" in caplog.text) == enabled
    w.set_step(3)
    w.add_scalar("loss", 1.0)
    w.add_image("input", np.zeros((2, 2, 3)))
    w.close()
    assert not list(tmp_path.iterdir())
