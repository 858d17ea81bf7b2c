"""Config-driven entry points: the port of the JAX package's
``config/parser.py``.

Same behaviour as the reference parser:

- a JSON config describes the run; components are built from
  ``{"type": ..., "args": {...}}`` blocks through registries;
- ``--set KEYCHAIN VALUE`` overrides any ``;``-separated nested key, the
  value JSON-decoded when possible; an explicit ``--set key null`` nulls the
  key, while a declared option never given on the CLI is skipped;
- ``-r`` finds the config snapshot next to (or above) the checkpoint or
  artifact; ``-c`` together with ``-r`` overlays the new config's top-level
  keys; ``-s`` overrides ``trainer.save_dir``;
- ``--auto-resume`` (when the entry point defines it and no ``-r`` is
  given) resumes from :func:`find_latest_checkpoint` of the ``-c``
  config's experiment (``-s`` honoured), or starts fresh when it has
  never checkpointed;
- the run directory ``save_dir/name/{train,test}/<MMDD_HHMMSS>`` receives
  the merged config and the ``info.log``; under a process group rank 0
  writes them, and its run id is every rank's;
- ``init_obj`` builds a component, ``init_ftn`` returns it with the
  config's args applied.
"""
from __future__ import annotations

import json
import logging
import re
from datetime import datetime
from functools import partial
from pathlib import Path

from ..observability.logging import setup_logging
from ..parallel import dist
from ..utils.util import read_json, write_json
from .registry import resolve


class ConfigParser:
    def __init__(self, config, resume=None, modification=None, run_id=None,
                 training=True):
        """
        :param config: dict of config (contents of a config JSON file).
        :param resume: path to a checkpoint or artifact, or None.
        :param modification: dict {keychain: value} of CLI overrides, where a
            keychain is ``;``-separated (e.g. ``arch;args;n_layer``).
        :param run_id: unique run identifier; timestamp when None.
        :param training: selects the ``train`` vs ``test`` run subdirectory.
        """
        self._config = _update_config(config, modification)
        self.resume = Path(resume).resolve() if resume is not None else None

        save_dir = Path(self.config["trainer"]["save_dir"])
        exper_name = self.config["name"]
        if run_id is None:
            run_id = dist.broadcast_object(
                datetime.now().strftime(r"%m%d_%H%M%S"))
        self._run_id = run_id
        traindir = "train" if training else "test"
        self._save_dir = (save_dir / exper_name / traindir / run_id).resolve()

        if dist.is_main_process():
            self.save_dir.mkdir(parents=True, exist_ok=True)
            write_json(self.config, self.save_dir / "config.json")
            setup_logging(self.save_dir)

        self.log_levels = {0: logging.WARNING, 1: logging.INFO,
                           2: logging.DEBUG}

    @staticmethod
    def parse_args(parser, options=(), argv=None):
        """``parser`` with the ``options`` flags and ``--set`` added, parsed
        from ``argv`` (default ``sys.argv``)."""
        for opt in options:
            parser.add_argument(*opt.flags, default=None, type=opt.type)
        parser.add_argument(
            "--set", action="append", nargs=2, default=None,
            metavar=("KEYCHAIN", "VALUE"),
            help="Override a ;-separated config keychain "
                 "(repeatable; VALUE parsed as JSON when possible).",
        )
        return parser.parse_args(argv)

    @classmethod
    def from_args(cls, args, options=(), training=True, argv=None):
        """Build from argparse. Returns ``(parsed_args, config_parser)``.

        ``args`` is an ``ArgumentParser`` (parsed here, from ``argv`` or
        ``sys.argv``, by :meth:`parse_args`) or a namespace that
        :meth:`parse_args` gave with the same ``options``."""
        if hasattr(args, "add_argument"):
            args = cls.parse_args(args, options, argv)

        if (getattr(args, "auto_resume", False) and args.resume is None
                and args.config is not None):
            scan_cfg = read_json(Path(args.config))
            if getattr(args, "save_dir", None) is not None:
                scan_cfg["trainer"]["save_dir"] = args.save_dir
            found = find_latest_checkpoint(scan_cfg)
            if found is not None:
                args.resume = str(found)
                logging.getLogger(__name__).warning(
                    "--auto-resume: resuming from %s", found)

        if args.resume is not None:
            resume = Path(args.resume)
            cfg_fname = _resume_config_path(resume)
        else:
            if args.config is None:
                raise ValueError(
                    "Configuration file needs to be specified. "
                    "Add '-c config.json', for example.")
            resume = None
            cfg_fname = Path(args.config)

        config = read_json(cfg_fname)
        if args.config and resume:
            # fine-tuning: overlay the new config's top-level keys
            config.update(read_json(args.config))
        if getattr(args, "save_dir", None) is not None:
            config["trainer"]["save_dir"] = args.save_dir

        modification = {}
        for opt in options:
            val = getattr(args, _get_opt_name(opt.flags))
            modification[opt.target] = _UNSET if val is None else val
        for chain, raw in (getattr(args, "set", None) or ()):
            modification[chain] = _parse_cli_value(raw)
        return args, cls(config, resume, modification, training=training)

    def init_obj(self, name, namespace, *args, **kwargs):
        """Instantiate the component described by config block ``name``:
        ``config.init_obj('arch', MODELS, device=d)`` is
        ``MODELS.get(config['arch']['type'])(**config['arch']['args'],
        device=d)``."""
        module_name = self[name]["type"]
        module_args = dict(self[name].get("args", {}))
        if any(k in module_args for k in kwargs):
            raise ValueError(
                "Overwriting kwargs given in config file is not allowed")
        module_args.update(kwargs)
        return resolve(namespace, module_name)(*args, **module_args)

    def init_ftn(self, name, namespace, *args, **kwargs):
        """The component of config block ``name`` with the config's args
        (and ``kwargs``) applied, not yet called."""
        module_name = self[name]["type"]
        module_args = dict(self[name].get("args", {}))
        if any(k in module_args for k in kwargs):
            raise ValueError(
                "Overwriting kwargs given in config file is not allowed")
        module_args.update(kwargs)
        return partial(resolve(namespace, module_name), *args,
                       **module_args)

    def __getitem__(self, name):
        return self.config[name]

    def __contains__(self, name):
        return name in self.config

    def get(self, name, default=None):
        return self.config.get(name, default)

    def get_logger(self, name, verbosity=2):
        if verbosity not in self.log_levels:
            raise ValueError(
                f"verbosity option {verbosity} is invalid. "
                f"Valid options are {list(self.log_levels)}.")
        logger = logging.getLogger(name)
        logger.setLevel(self.log_levels[verbosity])
        return logger

    @property
    def config(self):
        return self._config

    @property
    def save_dir(self) -> Path:
        return self._save_dir

    @property
    def log_dir(self) -> Path:
        return self._save_dir

    @property
    def run_id(self) -> str:
        return self._run_id


def find_latest_checkpoint(config: dict):
    """The checkpoint ``--auto-resume`` resumes: the run is the one whose
    newest checkpoint is newest (run ids carry no year, and a fresh
    retrain restarts the epochs); within it, ``(epoch, completeness,
    mtime)`` ranks. An epoch-edge checkpoint beats an interval slot or an
    emergency save of the same epoch; one of those from a later epoch
    wins; among them the newest wins; one whose sidecar is lost ranks at
    epoch 0. Hidden (temporary) directories are not checkpoints. None
    when the experiment has never checkpointed."""
    base = Path(config["trainer"]["save_dir"]) / config["name"] / "train"
    by_run: dict = {}
    if base.is_dir():
        for run in base.iterdir():
            cands = by_run.setdefault(run, [])
            for ck in run.glob("checkpoint-epoch*"):
                m = re.match(r"checkpoint-epoch(\d+)$", ck.name)
                if m and ck.is_dir():
                    cands.append((int(m.group(1)), 1, ck.stat().st_mtime,
                                  ck))
            for ck in (list(run.glob("checkpoint-interval-[ab]"))
                       + list(run.glob("checkpoint-emergency"))):
                if not ck.is_dir():
                    continue
                epoch = 0
                try:
                    epoch = int(json.loads(
                        (run / f"{ck.name}.meta.json").read_text()
                    ).get("epoch", 0))
                except (OSError, ValueError):
                    pass
                cands.append((epoch, 0, ck.stat().st_mtime, ck))
    runs = [c for c in by_run.values() if c]
    if not runs:
        return None
    newest_run = max(runs, key=lambda cands: max(c[2] for c in cands))
    return max(newest_run, key=lambda c: c[:3])[3]


def _resume_config_path(resume: Path) -> Path:
    """The run-dir config snapshot next to a checkpoint or artifact path:
    beside it, inside it, or two levels up."""
    for candidate in (resume.parent / "config.json", resume / "config.json",
                      resume.parent.parent / "config.json"):
        if candidate.exists():
            return candidate
    return resume.parent / "config.json"  # let read_json raise the clear error


_UNSET = object()  # unset CLI flag; distinct from an explicit null override


def _update_config(config, modification):
    if modification is None:
        return config
    for k, v in modification.items():
        if v is not _UNSET:
            _set_by_path(config, k, v)
    return config


def _get_opt_name(flags):
    for flg in flags:
        if flg.startswith("--"):
            return flg.lstrip("-").replace("-", "_")
    return flags[0].lstrip("-").replace("-", "_")


def _parse_cli_value(raw: str):
    """JSON-decode a ``--set`` value when possible, else keep the string."""
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return raw


def _set_by_path(tree, keys, value):
    """Set a ``;``-keychain, creating missing intermediate dicts."""
    keys = keys.split(";")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise TypeError(
                f"keychain {';'.join(keys)} crosses non-dict value at {k!r}"
            )
    node[keys[-1]] = value
