"""flax → torch weight conversion for the ResNet family.

The inverse of ``video_analytics_tpu/models/convert.torch_resnet_to_flax``:
it consumes the JAX package's ``{"params", "batch_stats"}`` tree (numpy
arrays, or anything ``np.asarray`` takes) and returns a torchvision-named
``state_dict`` for ``models/resnet.ResNet``.

Layout mapping (flax → torch):
- conv HWIO ``(kH, kW, I, O)`` → ``(O, I, kH, kW)``
- Dense ``(I, O)`` → ``(O, I)``
- BatchNorm scale/bias (params) → weight/bias; mean/var (batch_stats)
  → running_mean/running_var
- ``layer{i}_{j}/*`` → ``layer{i}.{j}.*``; ``downsample_conv`` /
  ``downsample_bn`` → ``downsample.0`` / ``downsample.1``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_BLOCK_NAMES = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2",
                "bn2": "bn2", "downsample_conv": "downsample.0",
                "downsample_bn": "downsample.1"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True, order="C"))


def _conv(p: Mapping[str, Any]) -> torch.Tensor:
    return _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))


def _bn(p: Mapping[str, Any], s: Mapping[str, Any], prefix: str,
        sd: Dict[str, torch.Tensor]) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])
    sd[prefix + ".running_mean"] = _t(s["mean"])
    sd[prefix + ".running_var"] = _t(s["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0)


def flax_to_torch(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One ResNet's flax variables → a ``state_dict`` for ``ResNet``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {"conv1.weight": _conv(params["conv1"])}
    _bn(params["bn1"], stats["bn1"], "bn1", sd)
    for name in sorted(params):
        if not name.startswith("layer"):
            continue
        stage, block = name[len("layer"):].split("_")
        prefix = f"layer{stage}.{block}."
        for flax_name, torch_name in _BLOCK_NAMES.items():
            if flax_name not in params[name]:
                continue
            if "conv" in flax_name:
                sd[prefix + torch_name + ".weight"] = _conv(
                    params[name][flax_name])
            else:
                _bn(params[name][flax_name], stats[name][flax_name],
                    prefix + torch_name, sd)
    if "fc" in params:
        sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
        sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


def two_stream_flax_to_torch(variables: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """``TwoStreamModel.init_variables`` output → a ``state_dict`` for
    ``models/two_stream.TwoStreamModel``."""
    sd: Dict[str, torch.Tensor] = {}
    for stream in ("spatial", "temporal"):
        for k, v in flax_to_torch(variables[stream]).items():
            sd[f"{stream}.{k}"] = v
    return sd
