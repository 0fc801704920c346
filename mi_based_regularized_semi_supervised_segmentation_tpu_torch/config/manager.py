"""YAML + dotted-key CLI config system.

Keeps the reference's config surface (same YAML keys, ``Key.sub=value`` CLI
overrides, ``--config_path`` swap of the default file) on a small typed core.
Reference behavior being reproduced: WHEEL::deepclustering2/configparser/
config_manager.py:10-54, _yaml_parser.py:18-156, _utils.py:62-87.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import yaml

DEFAULT_CONFIG_PATH = str(Path(__file__).resolve().parent / "semi.yaml")


def load_yaml(path: str | Path) -> Dict[str, Any]:
    with open(path) as f:
        out = yaml.safe_load(f)
    return out or {}


def dict_merge(base: Mapping[str, Any], override: Mapping[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; ``override`` wins. Returns a new dict."""
    result: Dict[str, Any] = {k: copy.deepcopy(v) for k, v in base.items()}
    for k, v in override.items():
        if k in result and isinstance(result[k], Mapping) and isinstance(v, Mapping):
            result[k] = dict_merge(result[k], v)
        else:
            result[k] = copy.deepcopy(v)
    return result


def _yaml_parse_scalar(text: str) -> Any:
    """Parse one value with YAML semantics so `Optim.lr=1e-5` gives a float,
    `Trainer.feature_names=[Conv5,Up_conv2]` gives a list, etc."""
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    # YAML 1.1 misses bare scientific notation like "1e-5"; treat it as float.
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


def parse_dotted_overrides(argv: Sequence[str]) -> Dict[str, Any]:
    """Turn ``["A.b=1", "C=hello"]`` into ``{"A": {"b": 1}, "C": "hello"}``."""
    out: Dict[str, Any] = {}
    for token in argv:
        if "=" not in token:
            raise ValueError(
                f"Config override {token!r} is not of the form Key.sub=value"
            )
        key, _, raw_value = token.partition("=")
        value = _yaml_parse_scalar(raw_value)
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"Conflicting override path at {part!r} in {token!r}")
        node[parts[-1]] = value
    return out


class ConfigManager:
    """Default YAML deep-merged with dotted-key argv overrides.

    ``--config_path <file>`` (or ``--config_path=<file>``) in argv swaps the
    default YAML, mirroring the reference CLI.
    """

    def __init__(
        self,
        default_path: str | Path = DEFAULT_CONFIG_PATH,
        argv: Optional[List[str]] = None,
        integrality_check: bool = True,
    ) -> None:
        if argv is None:
            argv = sys.argv[1:]
        argv = list(argv)

        config_path = str(default_path)
        cleaned: List[str] = []
        i = 0
        while i < len(argv):
            tok = argv[i]
            if tok == "--config_path":
                config_path = argv[i + 1]
                i += 2
                continue
            if tok.startswith("--config_path="):
                config_path = tok.split("=", 1)[1]
                i += 1
                continue
            cleaned.append(tok)
            i += 1

        self._default_path = config_path
        self._default_config = load_yaml(config_path)
        self._cli_config = parse_dotted_overrides(cleaned)
        self._config = dict_merge(self._default_config, self._cli_config)
        if integrality_check:
            self._validate(self._config)

    @staticmethod
    def _validate(config: Mapping[str, Any]) -> None:
        """Light schema validation — the reference had none; we type-check the
        load-bearing keys so typos fail fast instead of 100 epochs later."""
        trainer = config.get("Trainer", {})
        if "feature_names" in trainer and not isinstance(trainer["feature_names"], list):
            raise TypeError("Trainer.feature_names must be a list")
        if "feature_importance" in trainer and not isinstance(
            trainer["feature_importance"], list
        ):
            raise TypeError("Trainer.feature_importance must be a list")
        data = config.get("Data", {})
        for key in ("labeled_data_ratio", "unlabeled_data_ratio"):
            if key in data and not isinstance(data[key], (int, float)):
                raise TypeError(f"Data.{key} must be numeric")

    @property
    def config(self) -> Dict[str, Any]:
        return copy.deepcopy(self._config)

    @property
    def default_config(self) -> Dict[str, Any]:
        return copy.deepcopy(self._default_config)

    @property
    def cli_config(self) -> Dict[str, Any]:
        return copy.deepcopy(self._cli_config)

    def dump(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self._config, f, default_flow_style=False, sort_keys=False)
