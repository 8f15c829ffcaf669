"""Weight conversion between the reference's flax trees and torch.

``flax_to_torch`` is the inverse of
``video_analytics_tpu/models/convert.torch_resnet_to_flax``: it consumes
the JAX package's ``{"params", "batch_stats"}`` tree (numpy arrays, or
anything ``np.asarray`` takes) and returns a torchvision-named
``state_dict`` for ``models/resnet.ResNet``; ``torch_to_flax`` goes the
other way, so that ``runtime/checkpoint`` can write a file the JAX
package loads.  Both take BasicBlock and Bottleneck networks, the video
ResNet's (2+1)D convolutions (``models/video_resnet``: 5-D kernels, and
each ``Conv2Plus1d``'s ``spatial``, ``bn``, ``temporal`` flattened to
``conv1_spatial``, ``conv1_bn``, ``conv1_temporal``) and the folded form
(``{"params"}`` only, convolutions with a bias, no BatchNorm).  ``fold_batchnorm`` is the port's copy of the reference's, on
numpy leaves.

Layout mapping (flax → torch):
- conv HWIO ``(kH, kW, I, O)`` → ``(O, I, kH, kW)``; 3-D ``(kT, kH, kW,
  I, O)`` → ``(O, I, kT, kH, kW)``
- Dense ``(I, O)`` → ``(O, I)``
- BatchNorm scale/bias (params) → weight/bias; mean/var (batch_stats)
  → running_mean/running_var
- ``layer{i}_{j}/*`` → ``layer{i}.{j}.*``; ``downsample_conv`` /
  ``downsample_bn`` → ``downsample.0`` / ``downsample.1``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

_BLOCK_NAMES = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2",
                "bn2": "bn2", "conv3": "conv3", "bn3": "bn3",
                "downsample_conv": "downsample.0",
                "downsample_bn": "downsample.1",
                **{f"conv{i}_{part}": f"conv{i}.{part}" for i in (1, 2)
                   for part in ("spatial", "bn", "temporal")}}
_FLAX_NAMES = {v: k for k, v in _BLOCK_NAMES.items()}
_BN_FOR_CONV = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
                "downsample_conv": "downsample_bn",
                **{f"conv{i}_spatial": f"conv{i}_bn" for i in (1, 2)},
                **{f"conv{i}_temporal": f"bn{i}" for i in (1, 2)}}
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True, order="C"))


def _n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32)


def _conv(p: Mapping[str, Any], prefix: str,
          sd: Dict[str, torch.Tensor]) -> None:
    k = np.asarray(p["kernel"])
    sd[prefix + ".weight"] = _t(np.transpose(
        k, (k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))))
    if "bias" in p:                      # the folded form
        sd[prefix + ".bias"] = _t(p["bias"])


def _bn(p: Mapping[str, Any], s: Mapping[str, Any], prefix: str,
        sd: Dict[str, torch.Tensor]) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])
    sd[prefix + ".running_mean"] = _t(s["mean"])
    sd[prefix + ".running_var"] = _t(s["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0)


def _module(name: str, params: Mapping[str, Any], stats: Mapping[str, Any],
            prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    if "bn" in name:
        _bn(params[name], stats[name], prefix, sd)
    else:
        _conv(params[name], prefix, sd)


def flax_to_torch(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One ResNet's flax variables → a ``state_dict`` for ``ResNet``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted(params):
        if name in _BLOCK_NAMES:                  # the stem
            _module(name, params, stats, _BLOCK_NAMES[name], sd)
        elif name.startswith("layer"):
            stage, block = name[len("layer"):].split("_")
            for flax_name in params[name]:
                _module(flax_name, params[name], stats.get(name, {}),
                        f"layer{stage}.{block}.{_BLOCK_NAMES[flax_name]}", sd)
    if "fc" in params:
        sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
        sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


def torch_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A ``ResNet`` ``state_dict`` → the reference's variable tree with
    numpy leaves: ``{"params", "batch_stats"}``, or ``{"params"}`` alone
    for the folded form."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}

    def slot(tree: str, path) -> Dict[str, Any]:
        node = out[tree]
        for key in path:
            node = node.setdefault(key, {})
        return node

    for key, value in sd.items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        if mod[0].startswith("layer"):
            path = [f"{mod[0]}_{mod[1]}", _FLAX_NAMES[".".join(mod[2:])]]
        else:
            path = [_FLAX_NAMES.get(".".join(mod), mod[0])]
        if path[-1] == "fc":
            slot("params", path)["kernel" if leaf == "weight" else "bias"] = (
                _n(value).T.copy() if leaf == "weight" else _n(value))
        elif "bn" in path[-1]:
            tree, name = _BN_LEAVES[leaf]
            slot(tree, path)[name] = _n(value)
        elif leaf == "weight":
            w = _n(value)
            slot("params", path)["kernel"] = np.ascontiguousarray(
                np.transpose(w, (*range(2, w.ndim), 1, 0)))
        else:
            slot("params", path)["bias"] = _n(value)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def torch_resnet_to_flax(sd: Mapping[str, Any],
                         stage_sizes: Sequence[int] = (2, 2, 2, 2),
                         include_fc: bool = True) -> Dict[str, Any]:
    """A torch(vision) ResNet ``state_dict`` (tensors or numpy arrays) →
    ``{"params", "batch_stats"}`` with numpy leaves, as the reference's
    ``torch_resnet_to_flax`` returns it: the stem, the blocks of
    `stage_sizes` (BasicBlock or Bottleneck, by the keys present) and,
    with `include_fc`, the classifier; other keys are ignored.  Raises
    KeyError where a block of `stage_sizes` is missing (the wrong
    architecture)."""
    blocks = [f"layer{stage + 1}.{block}."
              for stage, n in enumerate(stage_sizes) for block in range(n)]
    missing = [k for k in ["conv1.weight", "bn1.weight"]
               + [b + "conv1.weight" for b in blocks] if k not in sd]
    if missing:
        raise KeyError(f"state_dict has no {missing[0]} (stage_sizes "
                       f"{tuple(stage_sizes)})")
    prefixes = ("conv1.", "bn1.", *blocks,
                *(("fc.",) if include_fc and "fc.weight" in sd else ()))
    kept = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
            else v for k, v in sd.items() if k.startswith(prefixes)}
    return torch_to_flax(kept)


def inflate_stem_for_flow(variables: Mapping[str, Any],
                          stack: int) -> Dict[str, Any]:
    """Cross-modality init of the flow stream (Wang et al. 2016): the RGB
    stem kernel averaged over its input channels and repeated across the
    2·stack flow channels, which keeps the response's scale."""
    out = {"params": dict(variables["params"]),
           "batch_stats": dict(variables["batch_stats"])}
    k = np.asarray(out["params"]["conv1"]["kernel"])   # (7, 7, 3, 64)
    mean_k = k.mean(axis=2, keepdims=True)             # (7, 7, 1, 64)
    out["params"]["conv1"] = {"kernel": np.repeat(mean_k, 2 * stack, axis=2)}
    return out


def fold_batchnorm(variables: Mapping[str, Any], eps: float = 1e-5
                   ) -> Dict[str, Any]:
    """Fold inference BatchNorms into the preceding convolutions: with
    running statistics BN is the per-channel affine y = s·x + (bias −
    mean·s), s = scale/√(var+ε), which composes exactly (in float32) with
    a bias-free convolution: W'[..., o] = W[..., o]·s[o], b'[o] = bias[o]
    − mean[o]·s[o].  Consumes an unfolded ``{"params", "batch_stats"}``
    tree and returns ``{"params"}`` for the ``fold_bn=True`` model."""
    f32 = np.float32

    def walk(p: Mapping[str, Any], s: Mapping[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in p.items():
            bn_key = _BN_FOR_CONV.get(k)
            if bn_key is not None and bn_key in p:
                bn, st = p[bn_key], s[bn_key]
                sc = (np.asarray(bn["scale"], f32)
                      / np.sqrt(np.asarray(st["var"], f32) + f32(eps)))
                out[k] = {"kernel": np.asarray(v["kernel"], f32) * sc,
                          "bias": (np.asarray(bn["bias"], f32)
                                   - np.asarray(st["mean"], f32) * sc)}
            elif k in _BN_FOR_CONV.values():
                continue                      # consumed by its convolution
            elif isinstance(v, Mapping) and "kernel" not in v \
                    and "scale" not in v:
                out[k] = walk(v, s.get(k, {}))
            else:
                out[k] = v                    # fc / anything unpaired
        return out

    return {"params": walk(dict(variables["params"]),
                           dict(variables.get("batch_stats", {})))}


def two_stream_flax_to_torch(variables: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """``TwoStreamModel.init_variables`` output → a ``state_dict`` for
    ``models/two_stream.TwoStreamModel``."""
    sd: Dict[str, torch.Tensor] = {}
    for stream in ("spatial", "temporal"):
        for k, v in flax_to_torch(variables[stream]).items():
            sd[f"{stream}.{k}"] = v
    return sd


def two_stream_torch_to_flax(sd: Mapping[str, torch.Tensor]
                             ) -> Dict[str, Any]:
    """A ``TwoStreamModel`` ``state_dict`` → the reference's
    ``{"spatial": ..., "temporal": ...}`` variable tree."""
    return {stream: torch_to_flax(
        {k[len(stream) + 1:]: v for k, v in sd.items()
         if k.startswith(stream + ".")})
        for stream in ("spatial", "temporal")}


def spynet_flax_to_torch(variables: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """The reference's SpyNet variables (``{"params": {"level{k}":
    {"conv{i}" | "conv_out": {"kernel", "bias"}}}}``) → a ``state_dict``
    for ``models/spynet.SpyNet`` (``nets.{k}.conv{i}.weight`` ...)."""
    sd: Dict[str, torch.Tensor] = {}
    for level, convs in variables["params"].items():
        k = int(level[len("level"):])
        for name, p in convs.items():
            _conv(p, f"nets.{k}.{name}", sd)
    return sd


def spynet_torch_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A ``SpyNet`` ``state_dict`` → the reference's ``{"params": ...}``
    tree with numpy leaves (conv OIHW → HWIO)."""
    params: Dict[str, Any] = {}
    for key, value in sd.items():
        _, k, name, leaf = key.split(".")
        node = params.setdefault(f"level{k}", {}).setdefault(name, {})
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(
                np.transpose(_n(value), (2, 3, 1, 0)))
        else:
            node["bias"] = _n(value)
    return {"params": params}
