"""The port's ``ConfigParser`` (config/parser.py) against the JAX
package's, on cases taken from tests/test_config.py: ``--set`` keychains
(nested, created, JSON-decoded, explicit null), resume rediscovery of the
config snapshot beside, inside or two levels above the ``-r`` path, the
``-c`` fine-tune overlay on ``-r``, and ``-s``.

Both parsers get the same argv on the same files; the merged configs, the
resume paths and the run-directory layout must be equal.
"""
import argparse
import json
import logging
import sys

import pytest

from pytorch_distributed_template_tpu.config import ConfigParser as JParser
from pytorch_distributed_template_tpu_torch.config import (
    ConfigParser as TParser, Registry, resolve,
)
from pytorch_distributed_template_tpu_torch.config import parser as tparser


def minimal_config(save_dir, name="UnitTest"):
    return {
        "name": name,
        "arch": {"type": "Dummy", "args": {"width": 4}},
        "trainer": {"save_dir": str(save_dir), "verbosity": 2,
                    "early_stop": 5},
    }


def _argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("-r", "--resume", default=None)
    ap.add_argument("-s", "--save_dir", default=None)
    return ap


def _both(argv, training=False):
    """Run both parsers on ``argv``: ``(jax_parser, torch_parser)``."""
    saved = sys.argv
    sys.argv = ["prog", *argv]
    try:
        _, jp = JParser.from_args(_argparser(), (), training=training)
    finally:
        sys.argv = saved
    _, tp = TParser.from_args(_argparser(), (), training=training,
                              argv=argv)
    return jp, tp


def _argv(case, tmp_path, run_dir):
    return [a.replace("{tmp}", str(tmp_path)).replace("{run}", str(run_dir))
            for a in CASES[case]]


def _layout(tmp_path):
    """A run dir holding a config snapshot, a checkpoint dir in it and a
    file two levels down; a fine-tune overlay; a plain config file."""
    run_dir = tmp_path / "Exp" / "train" / "0101_000000"
    (run_dir / "checkpoint-epoch3" / "state").mkdir(parents=True)
    (run_dir / "config.json").write_text(
        json.dumps(minimal_config(tmp_path, name="Exp")))
    (tmp_path / "ft.json").write_text(json.dumps(
        {"arch": {"type": "Dummy", "args": {"width": 64}}}))
    (tmp_path / "c.json").write_text(json.dumps(minimal_config(tmp_path)))
    return run_dir


CASES = {
    "set_keychains": ["-c", "{tmp}/c.json",
                      "--set", "arch;args;width", "64",
                      "--set", "arch;args;seq_layout", "zigzag",
                      "--set", "mesh;axes", '{"data": 2, "seq": 4}'],
    "set_null": ["-c", "{tmp}/c.json", "--set", "trainer;early_stop",
                 "null"],
    "save_dir_flag": ["-c", "{tmp}/c.json", "-s", "{tmp}/elsewhere"],
    "resume_beside": ["-r", "{run}/checkpoint-epoch3"],
    "resume_inside": ["-r", "{run}"],
    "resume_two_up": ["-r", "{run}/checkpoint-epoch3/state"],
    "resume_overlay": ["-r", "{run}/checkpoint-epoch3", "-c",
                       "{tmp}/ft.json"],
    "resume_overlay_set": ["-r", "{run}/checkpoint-epoch3", "-c",
                           "{tmp}/ft.json", "--set", "arch;args;depth",
                           "3"],
}


@pytest.mark.parametrize("training", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_from_args_matches_jax(tmp_path, case, training):
    run_dir = _layout(tmp_path)
    jp, tp = _both(_argv(case, tmp_path, run_dir), training=training)
    assert json.dumps(tp.config) == json.dumps(jp.config)   # order too
    assert tp.resume == jp.resume
    assert tp.save_dir.parent == jp.save_dir.parent
    assert tp.save_dir.parent.name == ("train" if training else "test")
    snap = json.loads((tp.save_dir / "config.json").read_text())
    assert snap == json.loads(json.dumps(jp.config))


def test_overrides_land_where_expected(tmp_path):
    run_dir = _layout(tmp_path)
    _, tp = _both(_argv("resume_overlay_set", tmp_path, run_dir))
    assert tp["arch"]["args"] == {"width": 64, "depth": 3}  # overlay + set
    assert tp["name"] == "Exp"                               # base kept
    assert tp.resume == run_dir / "checkpoint-epoch3"
    _, tp = _both(_argv("set_null", tmp_path, run_dir))
    assert tp["trainer"]["early_stop"] is None
    assert tp["arch"]["args"]["width"] == 4


@pytest.mark.parametrize("raw, value", [
    ("0.002", 0.002), ("true", True), ("null", None), ("7", 7),
    ('{"data": 2, "seq": 4}', {"data": 2, "seq": 4}), ("zigzag", "zigzag"),
])
def test_parse_cli_value(raw, value):
    from pytorch_distributed_template_tpu.config.parser import (
        _parse_cli_value as jparse,
    )

    assert tparser._parse_cli_value(raw) == jparse(raw) == value


def test_set_by_path_creates_and_refuses_non_dict():
    tree = {"arch": {"args": {}}}
    tparser._set_by_path(tree, "arch;args;seq_layout", "zigzag")
    tparser._set_by_path(tree, "mesh;axes", {"data": 2})
    assert tree == {"arch": {"args": {"seq_layout": "zigzag"}},
                    "mesh": {"axes": {"data": 2}}}
    with pytest.raises(TypeError):
        tparser._set_by_path({"a": 3}, "a;b", 1)


def test_missing_config_and_resume_without_snapshot(tmp_path):
    with pytest.raises(ValueError, match="Configuration file"):
        TParser.from_args(_argparser(), (), argv=[])
    with pytest.raises(FileNotFoundError):
        TParser.from_args(_argparser(), (),
                          argv=["-r", str(tmp_path / "nowhere" / "ck")])


def test_init_obj_and_logger(tmp_path):
    reg = Registry("test_models")

    @reg.register("Dummy")
    class Dummy:
        def __init__(self, width, extra=0):
            self.width, self.extra = width, extra

    parser = TParser(minimal_config(tmp_path), run_id="r", training=False)
    assert parser.save_dir == tmp_path / "UnitTest" / "test" / "r"
    obj = parser.init_obj("arch", reg, extra=7)
    assert (obj.width, obj.extra) == (4, 7)
    with pytest.raises(ValueError, match="Overwriting"):
        parser.init_obj("arch", reg, width=9)
    assert parser.get_logger("x", verbosity=1).level == logging.INFO
    with pytest.raises(ValueError, match="verbosity"):
        parser.get_logger("x", verbosity=9)


def test_registry_duplicate_missing_and_module_fallback():
    import types

    reg = Registry("r")
    reg.register("a")(lambda: 1)
    with pytest.raises(KeyError, match="already registered"):
        reg.register("a")(lambda: 2)
    with pytest.raises(KeyError, match="Available"):
        reg.get("nope")
    assert "a" in reg and reg.names() == ["a"] and reg.get("a")() == 1
    assert resolve(types.SimpleNamespace(D=lambda: 5), "D")() == 5
