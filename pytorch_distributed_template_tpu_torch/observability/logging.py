"""Hierarchical logging configured from JSON dictConfig (a copy of the JAX
package's ``observability/logging.py``).

Console handler at DEBUG with bare messages plus a rotating ``info.log``
file handler (INFO, timestamps, 10 MiB x 20 backups) whose path is
rewritten into the run directory.
"""
from __future__ import annotations

import logging
import logging.config
from pathlib import Path

from ..utils.util import read_json

DEFAULT_CONFIG = Path(__file__).parent / "logger_config.json"


def setup_logging(save_dir, log_config=DEFAULT_CONFIG,
                  default_level=logging.INFO) -> None:
    """Setup logging configuration, rewriting file-handler paths into
    ``save_dir``. Falls back to ``basicConfig`` when the JSON is missing."""
    log_config = Path(log_config)
    if log_config.is_file():
        config = read_json(log_config)
        for handler in config.get("handlers", {}).values():
            if "filename" in handler:
                handler["filename"] = str(Path(save_dir) / handler["filename"])
        logging.config.dictConfig(config)
    else:
        print(f"logging config {log_config} missing; "
              "falling back to basicConfig")
        logging.basicConfig(level=default_level)
