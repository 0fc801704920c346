"""Convert the JAX package's parameters into the port's ``state_dict``s.

Inputs are the flax ``params`` / ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of a TrainState's fields); this module needs
neither JAX nor flax. Maps:
  conv kernel [kh, kw, in, out]          -> Conv2d.weight [out, in, kh, kw]
  BN scale / bias + batch_stats mean/var -> weight / bias / running_mean / running_var
  Dense / head kernel [dim, S*K], bias   -> Linear.weight [S*K, dim], bias
  mlp head w1, b1, w2, b2                -> the same names and shapes
  projection heads' Dense_i / Conv_i     -> hidden / out Linear, conv0 / conv1
A decoder head that emits logits (``local_emit_logits``, the fused path) has
the same parameters as one that emits probabilities, so the same map serves.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


BLOCKS = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5",
          "Up_conv5", "Up_conv4", "Up_conv3", "Up_conv2")
UPS = ("Up5", "Up4", "Up3", "Up2")


def _t(x) -> torch.Tensor:
    return torch.tensor(np.array(x, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _bn(prefix: str, params: Mapping[str, Any], stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(params["scale"]), f"{prefix}.bias": _t(params["bias"]),
            f"{prefix}.running_mean": _t(stats["mean"]), f"{prefix}.running_var": _t(stats["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def unet_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """flax UNet ``params``/``batch_stats`` -> ``UNet.state_dict()`` layout."""
    sd: Dict[str, torch.Tensor] = {}
    for name in BLOCKS:
        p, s = params[name], batch_stats[name]
        sd[f"{name}.conv.0.weight"] = _conv(p["conv0"]["kernel"])
        sd.update(_bn(f"{name}.conv.1", p["bn0"], s["bn0"]))
        sd[f"{name}.conv.3.weight"] = _conv(p["conv1"]["kernel"])
        sd.update(_bn(f"{name}.conv.4", p["bn1"], s["bn1"]))
    for name in UPS:
        p, s = params[name], batch_stats[name]
        sd[f"{name}.up.1.weight"] = _conv(p["conv"]["kernel"])
        sd.update(_bn(f"{name}.up.2", p["bn"], s["bn"]))
    sd["DeConv_1x1.weight"] = _conv(params["DeConv_1x1"]["kernel"])
    sd["DeConv_1x1.bias"] = _t(params["DeConv_1x1"]["bias"])
    return sd


MLP_PARAMS = ("w1", "b1", "w2", "b2")


def cluster_head_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``ClusterHead`` or ``LocalClusterHead`` ``params`` (a bare head:
    linear, whose dense kernel sits under ``linear`` in the global head, or
    mlp) -> the head's ``state_dict()``."""
    if "w1" in params:  # mlp, encoder or decoder: the JAX names and shapes
        return {k: _t(params[k]) for k in MLP_PARAMS}
    dense = params.get("linear", params)
    return {"linear.weight": _t(np.asarray(dense["kernel"]).T), "linear.bias": _t(dense["bias"])}


def projector_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ProjectorWrapper ``params`` (linear or mlp heads) ->
    ``ProjectorWrapper.state_dict()``."""
    return {f"heads.{name}.{k}": v for name, p in params.items()
            for k, v in cluster_head_state_dict(p).items()}


def projection_head_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``ProjectionHead`` ``params`` (``Dense_0``, and ``Dense_1`` for
    mlp) -> ``ProjectionHead.state_dict()``."""
    dense = [params[k] for k in sorted(params)]
    names = ("hidden", "out") if len(dense) == 2 else ("out",)
    sd: Dict[str, torch.Tensor] = {}
    for name, p in zip(names, dense):
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def local_projection_head_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``LocalProjectionHead`` ``params`` (``Conv_0``, and ``Conv_1``
    for mlp) -> ``LocalProjectionHead.state_dict()``."""
    sd: Dict[str, torch.Tensor] = {}
    for i, key in enumerate(sorted(params)):
        sd[f"conv{i}.weight"] = _conv(params[key]["kernel"])
        sd[f"conv{i}.bias"] = _t(params[key]["bias"])
    return sd
