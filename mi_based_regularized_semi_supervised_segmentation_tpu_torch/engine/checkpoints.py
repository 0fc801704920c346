"""Checkpoints: save, strict load and lenient load of the trainer's state
(counterpart of the JAX package's ``engine/checkpoints.py``).

A checkpoint is one ``torch.save`` file, ``last.pth`` (every epoch) or
``best.pth`` (when the val score improves): the trainer's state (a nested
dict of tensors and plain values, ``SemiTrainer.state_dict``) with the host
metadata (epoch, best score, ``Storage`` history, mode) under ``"meta"``.
It is written to a temporary file and renamed over the old one, so a job
killed mid-write leaves the previous checkpoint whole.

A path to load may be a file or a run directory; a directory resolves to
``last.pth`` for a resume and to ``best.pth`` for inference.

- ``load_checkpoint`` (strict) raises unless the file holds exactly the
  template's entries, each of the template's shape.
- ``lenient_load_checkpoint`` takes each entry whose name (its path in the
  nested dict) and shape match the template and keeps the template's value
  for every other: a ``partial`` checkpoint loads into a ``udaiic`` trainer
  with the projector left at its initial values.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

LAST_NAME = "last.pth"
BEST_NAME = "best.pth"
META_KEY = "meta"


def resolve_checkpoint(path: str | Path, name: str = LAST_NAME) -> Path:
    """``path`` itself, or ``path / name`` when it is a directory; raises
    ``FileNotFoundError`` when that file does not exist."""
    p = Path(path)
    if p.is_dir():
        p = p / name
    if not p.is_file():
        raise FileNotFoundError(f"no checkpoint at {p}")
    return p


def save_checkpoint(path: str | Path, state: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Writes ``{**state, "meta": meta}`` to a temporary file beside ``path``
    and renames it over ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    try:
        torch.save({**state, META_KEY: meta}, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _read(path: str | Path, name: str) -> Tuple[Path, Dict[str, Any]]:
    p = resolve_checkpoint(path, name)
    return p, torch.load(p, map_location="cpu", weights_only=True)


def _split(payload: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    state = {k: v for k, v in payload.items() if k != META_KEY}
    return state, dict(payload.get(META_KEY) or {})


def _same_leaf(template: Any, value: Any) -> bool:
    """A tensor matches a tensor of its shape; any other leaf a value of its
    type (None matches None only)."""
    if isinstance(template, torch.Tensor):
        return isinstance(value, torch.Tensor) and value.shape == template.shape
    return type(value) is type(template)


def _children(node: Any):
    if isinstance(node, dict):
        return node.items()
    return enumerate(node)


def mismatches(template: Any, value: Any, path: str = "") -> List[str]:
    """Paths at which ``value`` lacks, adds or reshapes an entry of
    ``template`` (nested dicts and lists; tensors compared by shape)."""
    if not isinstance(template, (dict, list, tuple)):
        return [] if _same_leaf(template, value) else [
            f"{path}: {_describe(template)} in the trainer, {_describe(value)} in the checkpoint"]
    if type(value) is not type(template) or (
            not isinstance(template, dict) and len(value) != len(template)):
        return [f"{path or '/'}: {_describe(template)} in the trainer, "
                f"{_describe(value)} in the checkpoint"]
    out = []
    if isinstance(template, dict):
        out += [f"{path}/{k}: not in the trainer" for k in value if k not in template]
        out += [f"{path}/{k}: missing" for k in template if k not in value]
    for k, v in _children(template):
        if not isinstance(template, dict) or k in value:
            out += mismatches(v, value[k], f"{path}/{k}")
    return out


def _describe(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return f"tensor{list(x.shape)}"
    if isinstance(x, (dict, list, tuple)):
        return f"{type(x).__name__} of {len(x)}"
    return type(x).__name__


def _overlay(template: Any, value: Any) -> Tuple[Any, int]:
    """``template`` with each leaf replaced by ``value``'s at the same path
    where the two match (``_same_leaf``); returns it with the number of
    template leaves kept."""
    if isinstance(template, (dict, list, tuple)):
        same_kind = type(value) is type(template)
        merged, kept = {}, 0
        for k, v in _children(template):
            present = same_kind and (k in value if isinstance(template, dict) else k < len(value))
            if present:
                merged[k], n = _overlay(v, value[k])
            else:
                merged[k], n = v, _count_leaves(v)
            kept += n
        if isinstance(template, dict):
            return merged, kept
        return type(template)(merged[i] for i in range(len(template))), kept
    if _same_leaf(template, value):
        return value, 0
    return template, 1


def _count_leaves(node: Any) -> int:
    if isinstance(node, (dict, list, tuple)):
        return sum(_count_leaves(v) for _, v in _children(node))
    return 1


def load_checkpoint(path: str | Path, template: Dict[str, Any], name: str = LAST_NAME
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Strict load: (state, meta); raises ``ValueError`` naming every entry
    that is missing, extra or of another shape than in ``template``."""
    p, payload = _read(path, name)
    state, meta = _split(payload)
    bad = mismatches(template, state)
    if bad:
        raise ValueError(f"checkpoint {p} does not match the trainer ({len(bad)} entries): "
                         + "; ".join(bad[:20]))
    return state, meta


def lenient_load_checkpoint(path: str | Path, template: Dict[str, Any], name: str = LAST_NAME
                            ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """Lenient load: (state, meta, kept), where state is ``template`` with
    every entry whose path and shape match taken from the checkpoint, and
    kept counts the template's leaves left as they were."""
    _, payload = _read(path, name)
    state, meta = _split(payload)
    merged, kept = _overlay(template, state)
    return merged, meta, kept
