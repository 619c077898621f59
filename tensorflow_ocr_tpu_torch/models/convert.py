"""Weight bridge: the JAX package's Flax variables -> this port's state_dict.

Input is ``{"params": ..., "batch_stats": ...}`` as a nested mapping of
arrays, or that tree flattened to ``/``-joined keys (the ``.npz`` written
by ``scripts/export_torch_weights.py``). Leaves are renamed and conv
kernels transposed from HWIO to OIHW:

    params/<m>/Conv_0/kernel          -> <m>.conv.weight
    params/<m>/BatchNorm_0/scale      -> <m>.bn.weight
    params/<m>/BatchNorm_0/bias       -> <m>.bn.bias
    batch_stats/<m>/BatchNorm_0/mean  -> <m>.bn.running_mean
    batch_stats/<m>/BatchNorm_0/var   -> <m>.bn.running_var
    params/<m>/kernel, bias           -> <m>.weight, <m>.bias

Uses numpy and torch only.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}


def flatten_variables(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> ``{"params/a/b": array}``; a flat mapping passes
    through."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def torch_key(flax_key: str) -> Tuple[str, bool]:
    """(state_dict key, whether the value is an HWIO kernel to transpose)."""
    collection, *mods, leaf = flax_key.split("/")
    if mods and mods[-1] == "BatchNorm_0" and (collection, leaf) in _BN_LEAVES:
        return ".".join(mods[:-1] + ["bn", _BN_LEAVES[collection, leaf]]), False
    if collection == "params" and mods and leaf in ("kernel", "bias"):
        if mods[-1] == "Conv_0":
            mods = mods[:-1] + ["conv"]
        return ".".join(mods + ["weight" if leaf == "kernel" else "bias"]), \
            leaf == "kernel"
    raise ValueError(f"no state_dict counterpart for Flax variable {flax_key}")


def convert_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables (nested or flat) -> a state_dict of float32 tensors."""
    state = {}
    for k, v in flatten_variables(variables).items():
        key, is_kernel = torch_key(k)
        if is_kernel:
            v = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        state[key] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return state


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """State dict from a flat ``.npz`` of Flax variables."""
    with np.load(path) as z:
        return convert_variables({k: z[k] for k in z.files})


def load_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load Flax variables into ``model``; every key on both sides must be
    used (``strict=True``)."""
    model.load_state_dict(convert_variables(variables), strict=True)
    return model
