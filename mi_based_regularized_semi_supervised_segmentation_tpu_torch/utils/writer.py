"""Experiment writer: a JSONL event log.

The JSONL sink of the JAX package's ``utils/writer.py`` (per-epoch flattened
scalar tags under tra/ val/ test/ sections, one JSON object per epoch in
events.jsonl); its optional TensorBoard sink is not carried over."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

from .general import flatten_dict


class SummaryWriter:
    def __init__(self, save_dir: str | Path) -> None:
        self._dir = Path(save_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._events = open(self._dir / "events.jsonl", "a")

    def add_scalars_from_income_dict(self, income: Mapping[str, Any], epoch: int) -> None:
        flat = {}
        for section, result in income.items():
            if result is None:
                continue
            for k, v in flatten_dict(result).items():
                try:
                    flat[f"{section}/{k}"] = float(v)
                except (TypeError, ValueError):
                    pass
        self._events.write(json.dumps({"epoch": int(epoch), **flat}) + "\n")
        self._events.flush()

    def close(self) -> None:
        self._events.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
