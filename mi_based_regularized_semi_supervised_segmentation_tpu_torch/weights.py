"""Convert the JAX package's parameters into the port's ``state_dict``s.

Inputs are the flax ``params`` / ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of a TrainState's fields); this module needs
neither JAX nor flax. Maps:
  conv kernel [kh, kw, in, out]          -> Conv2d.weight [out, in, kh, kw]
  BN scale / bias + batch_stats mean/var -> weight / bias / running_mean / running_var
  Dense / head kernel [dim, S*K], bias   -> Linear.weight [S*K, dim], bias
  mlp head w1, b1, w2, b2                -> the same names and shapes
  projection heads' Dense_i / Conv_i     -> hidden / out Linear, conv0 / conv1
  zoo and VGG modules (the same names)   -> the same path: 3-D kernels
                                            [kd, kh, kw, in, out] -> [out, in, kd, kh, kw],
                                            ConvTranspose kernels flipped in their
                                            spatial axes -> [in, out, kd, kh, kw],
                                            Dense kernels transposed, PReLU slopes [1]
A decoder head that emits logits (``local_emit_logits``, the fused path) has
the same parameters as one that emits probabilities, so the same map serves.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

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


def _unet_blocks(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                 ) -> Dict[str, torch.Tensor]:
    """The ConvBlocks and UpConvs of a flax U-Net skeleton -> the port's
    ``ConvBlock`` (``conv.{0,1,3,4}``) / ``UpConv`` (``up.{1,2}``) names."""
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
    return sd


def unet_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """flax UNet ``params``/``batch_stats`` -> ``UNet.state_dict()`` layout."""
    sd = _unet_blocks(params, batch_stats)
    sd["DeConv_1x1.weight"] = _conv(params["DeConv_1x1"]["kernel"])
    sd["DeConv_1x1.bias"] = _t(params["DeConv_1x1"]["bias"])
    return sd


def _kernel(kernel, transposed: bool) -> torch.Tensor:
    k = np.asarray(kernel)
    if k.ndim == 2:  # Dense [in, out] -> Linear [out, in]
        return _t(k.T)
    spatial = tuple(range(k.ndim - 2))
    if transposed:  # flax does not flip a ConvTranspose kernel; conv_transpose does
        return _t(np.transpose(np.flip(k, spatial), (k.ndim - 2, k.ndim - 1) + spatial))
    return _t(np.transpose(k, (k.ndim - 1, k.ndim - 2) + spatial))


def zoo_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None = None,
                   transposed: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """flax ``params`` / ``batch_stats`` of a module whose port has the same
    names (``models/zoo.py``, ``models/vgg.py``) -> its ``state_dict()``:
    each conv / dense ``kernel`` and ``bias``, BN ``scale`` / ``bias`` with
    its statistics, PReLU ``negative_slope``. ``transposed``: the paths
    (``up1``) of ``nn.ConvTranspose`` modules."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(p: Mapping[str, Any], s: Mapping[str, Any], prefix: str) -> None:
        if "scale" in p:
            sd.update(_bn(prefix, p, s))
        elif "negative_slope" in p:
            sd[f"{prefix}.weight"] = _t(np.reshape(p["negative_slope"], (1,)))
        elif "kernel" in p:
            sd[f"{prefix}.weight"] = _kernel(p["kernel"], prefix in transposed)
            if "bias" in p:
                sd[f"{prefix}.bias"] = _t(p["bias"])
        else:
            for name, child in p.items():
                walk(child, s.get(name, {}), f"{prefix}.{name}" if prefix else name)

    walk(params, batch_stats or {}, "")
    return sd


def attention_unet_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """flax ``AttentionUNet``: its U-Net blocks as ``unet_state_dict`` maps
    them, the gates and the head by name."""
    blocks = set(BLOCKS) | set(UPS)
    sd = _unet_blocks(params, batch_stats)
    sd.update(zoo_state_dict({k: v for k, v in params.items() if k not in blocks}))
    return sd


VNET_TRANSPOSED = ("up1", "up2", "up3")


def arch_state_dict(arch: str, params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any] | None = None) -> Dict[str, torch.Tensor]:
    """flax variables of the model ``get_arch(arch, ...)`` builds -> the
    port model's ``state_dict()``."""
    arch = arch.lower()
    if arch in ("unet", "contrastunet"):
        return unet_state_dict(params, batch_stats)
    if arch == "attention_unet":
        return attention_unet_state_dict(params, batch_stats)
    return zoo_state_dict(params, batch_stats,
                          transposed=VNET_TRANSPOSED if arch == "vnet" else ())


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
