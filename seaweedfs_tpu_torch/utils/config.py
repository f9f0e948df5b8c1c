"""TOML configuration files beside the launcher's flags.

Port of seaweedfs_tpu/utils/config.py, trimmed to `Config`,
`find_config_file` and `load_config` (reference weed/util/config.go:35-41:
`<name>.toml` from the working directory, `~/.seaweedfs_tpu/` and
`/etc/seaweedfs_tpu/`, the first found wins). The parser is the standard
library's `tomllib`; the JAX package's fallback parser for interpreters
older than 3.11 is not ported. Flags win: the launcher reads a key only
for a flag that was left unset.
"""

from __future__ import annotations

import os
import tomllib
from typing import Any

from .glog import logger

CONFIG_DIRS = (".", "~/.seaweedfs_tpu", "/etc/seaweedfs_tpu")


class Config:
    """A parsed TOML file with dotted-key access, as viper gives it."""

    def __init__(self, data: dict | None, path: str | None = None):
        self.data = data or {}
        self.path = path

    def __bool__(self) -> bool:
        return bool(self.data)

    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self.data
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_str(self, dotted: str, default: str = "") -> str:
        v = self.get(dotted, default)
        return default if v is None else str(v)


def find_config_file(name: str, dirs=CONFIG_DIRS) -> str | None:
    for d in dirs:
        path = os.path.join(os.path.expanduser(d), f"{name}.toml")
        if os.path.isfile(path):
            return path
    return None


def load_config(name: str, dirs=CONFIG_DIRS) -> Config:
    """`<name>.toml` from the search path; an empty Config where there is
    none or it does not parse (a bad file is reported and ignored, as
    viper's soft failure, so that it cannot take a node down)."""
    path = find_config_file(name, dirs)
    if path is None:
        return Config(None)
    try:
        with open(path, "rb") as f:
            return Config(tomllib.load(f), path)
    except (OSError, tomllib.TOMLDecodeError, UnicodeDecodeError) as e:
        logger("config").warning("ignoring %s: %s", path, e)
        return Config(None)
