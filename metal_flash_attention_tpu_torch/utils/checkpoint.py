"""Checkpoint and resume for parameter trees, LoRA adapters, optimizer
state and a data loader's position.

The port of the JAX package's `utils/checkpoint.py`, in its file format:
one `.npz` of the flattened leaves, each keyed by its path
(`utils.tree.leaf_paths`: dict keys, then list and tuple indices, joined
by ``/``), and a ``__meta__`` JSON entry naming the dtype of every leaf
numpy cannot hold (bf16 and the FP8 formats, stored as raw ``uint16`` /
``uint8`` views).  So a file written by either package restores in the
other bit for bit.  Writes are atomic (a ``.tmp.npz``, then
`os.replace`), and ``save(..., step=)`` keeps the newest ``keep``
``ckpt_{step:08d}.npz`` files.

The port's training state holds a `torch.optim.Optimizer`
(`models.optim.make_train_step`: ``{"opt": optimizer, "shadow": [...]}``).
An optimizer is saved through its ``state_dict()["state"]``, one leaf a
parameter index and entry (``opt/state/0/exp_avg``, ``.../step``), and
`restore` loads those into ``like``'s optimizer, whose hyperparameters
stay its own.  These keys are the port's: the JAX package stores optax's
state, which has another structure.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from metal_flash_attention_tpu_torch.utils.tree import flatten, leaf_paths

# Dtypes numpy cannot hold, stored as raw integer views.
_RAW = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
        "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
        "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}
_RAW_NAMES = {v[0]: k for k, v in _RAW.items()}


def _to_numpy(x) -> tuple[np.ndarray, Optional[str]]:
    """A leaf -> (the array to store, its dtype name when stored raw)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        name = _RAW_NAMES.get(t.dtype)
        if name is not None:
            raw = t.contiguous().view(_RAW[name][1]).cpu().numpy()
            return raw.view(_RAW[name][2]), name
        return t.cpu().numpy(), None
    return np.asarray(x), None


def _flatten(tree) -> dict:
    """path -> leaf, optimizers expanded into their state, Nones (no
    leaf, as in a JAX pytree) dropped."""
    flat = {}
    leaves, _ = flatten(tree)
    for key, leaf in zip(leaf_paths(tree), leaves):
        if leaf is None:
            continue
        if isinstance(leaf, torch.optim.Optimizer):
            for i, entry in leaf.state_dict()["state"].items():
                for name, v in entry.items():
                    flat[f"{key}/state/{i}/{name}"] = v
        else:
            flat[key] = leaf
    return flat


def save(path: str, tree: Any, *, step: Optional[int] = None,
         keep: int = 3) -> str:
    """Save ``tree`` under the directory ``path``; returns the file
    written.  With ``step`` the file is ``ckpt_{step:08d}.npz`` and only
    the newest ``keep`` such files stay."""
    os.makedirs(path, exist_ok=True)
    name = f"ckpt_{step:08d}.npz" if step is not None else "ckpt.npz"
    target = os.path.join(path, name)
    arrays, meta = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], raw = _to_numpy(v)
        if raw is not None:
            meta[k] = raw
    tmp = target + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, target)
    if step is not None:
        ckpts = sorted(f for f in os.listdir(path)
                       if re.fullmatch(r"ckpt_\d{8}\.npz", f))
        for old in ckpts[:-keep]:
            os.remove(os.path.join(path, old))
    return target


def latest(path: str) -> Optional[str]:
    """The newest checkpoint file under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    ckpts = sorted(f for f in os.listdir(path)
                   if re.fullmatch(r"ckpt(_\d{8})?\.npz", f))
    return os.path.join(path, ckpts[-1]) if ckpts else None


def _load(file: str) -> dict:
    with np.load(file, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        return {k: (data[k], meta.get(k)) for k in data.files
                if k != "__meta__"}


def _tensor(arr: np.ndarray, raw: Optional[str]) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if raw is not None:
        t = t.view(_RAW[raw][1]).view(_RAW[raw][0])
    return t


def _checked(flat: dict, key: str, shape) -> tuple:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr, raw = flat[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape} != "
                         f"model shape {tuple(shape)}")
    return arr, raw


def _restore_optimizer(opt: torch.optim.Optimizer, key: str,
                       flat: dict) -> torch.optim.Optimizer:
    """Load the saved per-parameter state under ``key`` into ``opt``
    (torch puts each entry on its parameter's device and dtype, and
    keeps ``step`` as saved)."""
    pattern = re.compile(re.escape(key) + r"/state/(\d+)/(\w+)")
    state: dict = {}
    for k, (arr, raw) in flat.items():
        m = pattern.fullmatch(k)
        if m:
            state.setdefault(int(m.group(1)), {})[m.group(2)] = _tensor(
                arr, raw)
    params = [p for g in opt.param_groups for p in g["params"]]
    if state and sorted(state) != list(range(len(params))):
        raise ValueError(f"optimizer {key!r}: checkpoint holds state for "
                         f"parameters {sorted(state)}, the optimizer has "
                         f"{len(params)}")
    for i, entry in state.items():
        for name, v in entry.items():
            if name != "step" and tuple(v.shape) != tuple(params[i].shape):
                raise ValueError(
                    f"leaf {key}/state/{i}/{name}: checkpoint shape "
                    f"{tuple(v.shape)} != model shape "
                    f"{tuple(params[i].shape)}")
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)
    return opt


def restore(file: str, like: Any) -> Any:
    """Restore a tree with the structure of ``like`` from ``file``.

    Each tensor leaf is written in place into ``like``'s tensor, so it
    keeps ``like``'s device and dtype (an optimizer holds its parameters
    by identity); Python numbers come back as Python numbers, and an
    optimizer gets its saved state.  A leaf missing from the file raises
    `KeyError`, one of another shape `ValueError`, as in the JAX
    package."""
    flat = _load(file)
    leaves, rebuild = flatten(like)
    out = []
    for key, leaf in zip(leaf_paths(like), leaves):
        if leaf is None:
            out.append(None)
        elif isinstance(leaf, torch.optim.Optimizer):
            out.append(_restore_optimizer(leaf, key, flat))
        elif isinstance(leaf, torch.Tensor):
            v = _tensor(*_checked(flat, key, leaf.shape))
            with torch.no_grad():
                leaf.copy_(v.to(leaf.device))
            out.append(leaf)
        else:
            arr, _ = _checked(flat, key, np.shape(leaf))
            out.append(type(leaf)(arr.item()))
    return rebuild(out)
