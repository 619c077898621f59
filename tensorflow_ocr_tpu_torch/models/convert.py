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
    params/<m>/scale                  -> <m>.weight
    batch_stats/<m>/mean, var         -> <m>.running_mean, running_var

(the last two for a BatchNorm of its own, such as ResNet-v2's ``preact``
and ``postnorm``; ``bias`` then maps by the rule above it.)

:func:`convert_train_state` turns a whole JAX ``TrainState`` (as numpy)
into the nested mapping of a port checkpoint
(``tensorflow_ocr_tpu_torch.train.trainer.state_tensors``): the EMA goes
through the same map, and the optimizer's state of
``optax.chain(add_decayed_weights, adam | sgd(momentum))`` becomes the
per-parameter state of the port's optimizer. Uses numpy and torch only.
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
# a BatchNorm module of its own (named, not a ConvBN's BatchNorm_0): its
# bias is any module's bias
_OWN_BN_LEAVES = {k: v for k, v in _BN_LEAVES.items()
                  if k != ("params", "bias")}


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
    if mods and (collection, leaf) in _OWN_BN_LEAVES:
        return ".".join(mods + [_OWN_BN_LEAVES[collection, leaf]]), False
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


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _optax_states(tree):
    """The optax states (named tuples) inside an ``opt_state`` tree."""
    if hasattr(tree, "_fields"):
        yield tree
        for v in tree:
            yield from _optax_states(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _optax_states(v)


def _param_tree(tree) -> Dict[str, torch.Tensor]:
    return convert_variables({"params": tree})


def convert_train_state(state) -> Dict[str, object]:
    """A JAX ``TrainState`` (a mapping or an object with its fields, leaves
    as arrays) -> ``{step, model, optimizer, ema}`` of a port checkpoint.

    ``params``, ``batch_stats`` and ``ema_params`` go through the key map;
    Adam's ``mu``/``nu`` (``ScaleByAdamState``) become ``exp_avg``/
    ``exp_avg_sq`` and its ``count`` each parameter's ``step``; momentum's
    ``trace`` (``TraceState``) becomes ``momentum_buffer``. Kernels go
    from HWIO to OIHW."""
    model = convert_variables({"params": _field(state, "params"),
                               "batch_stats": _field(state, "batch_stats")})
    ema = _param_tree(_field(state, "ema_params"))
    per_param: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in ema}
    found = False
    for st in _optax_states(_field(state, "opt_state")):
        fields = st._fields
        if "mu" in fields and "nu" in fields:
            count = torch.tensor(float(np.asarray(st.count)),
                                 dtype=torch.float32)
            for key, tree in (("exp_avg", st.mu), ("exp_avg_sq", st.nu)):
                for n, t in _param_tree(tree).items():
                    per_param[n][key] = t
            for n in per_param:
                per_param[n]["step"] = count.clone()
            found = True
        elif "trace" in fields:
            for n, t in _param_tree(st.trace).items():
                per_param[n]["momentum_buffer"] = t
            found = True
    if not found:
        raise ValueError("opt_state holds neither an Adam nor a momentum "
                         "state")
    step = torch.tensor(int(np.asarray(_field(state, "step"))),
                        dtype=torch.int64)
    return {"step": step, "model": model, "optimizer": per_param, "ema": ema}
