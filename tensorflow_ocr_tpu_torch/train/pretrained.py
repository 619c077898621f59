"""ImageNet warm start: a TF-slim checkpoint's tensors into the port.

Port of ``tensorflow_ocr_tpu/train/pretrained.py:31-136``. The reference
warm-starts its backbone from a TF-slim ImageNet checkpoint with
``slim.assign_from_checkpoint_fn(ignore_missing_vars=True)``. That
checkpoint is read as the ``.npz`` that ``scripts/convert_slim_checkpoint.py``
writes (it needs TensorFlow; the port reads the same file). Each slim name
maps onto a state_dict key of the port's modules:

    resnet_v1_50/conv1/weights                 -> backbone.conv1.conv.weight
    resnet_v1_50/block1/unit_1/bottleneck_v1/conv2/BatchNorm/gamma
                                   -> backbone.block1_unit1.conv2.bn.weight
    .../BatchNorm/beta, moving_mean, moving_variance
                                   -> .bn.bias, .bn.running_mean, .bn.running_var
    vgg_16/conv1/conv1_1/weights, biases       -> backbone.conv1_1.weight, bias

conv kernels go from slim's HWIO to OIHW. A tensor whose key the model
lacks or whose shape differs is skipped and not counted (the
``ignore_missing_vars`` semantics); logits, global step, optimizer and
moving-average slots are never read.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from tensorflow_ocr_tpu_torch.models.convert import torch_key

_SKIP = ("logits", "global_step", "Momentum", "Adam",
         "ExponentialMovingAverage", "biased", "local_step")
_BN = {"gamma": ("params", "scale"), "beta": ("params", "bias"),
       "moving_mean": ("batch_stats", "mean"),
       "moving_variance": ("batch_stats", "var")}


def _slim_to_flax_path(name: str) -> Optional[str]:
    """A slim name as the ``collection/…/leaf`` path of the JAX package's
    Flax variables (pretrained.py:31-71), or None."""
    name = name.split(":")[0]
    if any(s in name for s in _SKIP):
        return None
    m = re.match(r"resnet_v1_\d+/(.+)", name)
    if m:
        rest = m.group(1).replace("bottleneck_v1/", "")
        rest = re.sub(r"block(\d+)/unit_(\d+)/", r"block\1_unit\2/", rest)
        parts = rest.split("/")
        if parts[-1] == "weights":
            return "/".join(["params", "backbone", *parts[:-1], "Conv_0",
                             "kernel"])
        if len(parts) >= 2 and parts[-2] == "BatchNorm" and parts[-1] in _BN:
            coll, leaf = _BN[parts[-1]]
            return "/".join([coll, "backbone", *parts[:-2], "BatchNorm_0",
                             leaf])
        return None
    m = re.match(r"vgg_16/(.+)", name)
    if m:
        parts = m.group(1).split("/")
        if parts[-1] not in ("weights", "biases"):
            return None
        leaf = "kernel" if parts[-1] == "weights" else "bias"
        return "/".join(["params", "backbone", parts[-2], leaf])
    return None


def slim_to_torch_key(name: str) -> Optional[Tuple[str, bool]]:
    """(state_dict key, whether the tensor is an HWIO kernel) of one slim
    variable name, or None for a variable that is never imported."""
    path = _slim_to_flax_path(name)
    return None if path is None else torch_key(path)


def load_slim_npz(npz_path: str) -> Dict[str, torch.Tensor]:
    """The importable tensors of a converted slim ``.npz`` as a partial
    state_dict (float32 where slim stores float32; kernels OIHW)."""
    out = {}
    with np.load(npz_path) as raw:
        for name in raw.files:
            mapped = slim_to_torch_key(name)
            if mapped is None:
                continue
            key, is_kernel = mapped
            v = np.asarray(raw[name])
            if is_kernel:
                v = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def import_backbone(model_or_state_dict: Union[nn.Module,
                                               Mapping[str, torch.Tensor]],
                    npz_path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """The state_dict of ``model_or_state_dict`` with every slim tensor of
    ``npz_path`` whose key exists there with the same shape put in its
    place (cast to the live tensor's dtype), and the count of tensors
    taken. The model itself is not changed."""
    live = (model_or_state_dict.state_dict()
            if isinstance(model_or_state_dict, nn.Module)
            else model_or_state_dict)
    pre = load_slim_npz(npz_path)
    out, n = {}, 0
    for key, t in live.items():
        cand = pre.get(key)
        if cand is not None and cand.shape == t.shape:
            out[key] = cand.to(dtype=t.dtype)
            n += 1
        else:
            out[key] = t
    return out, n
