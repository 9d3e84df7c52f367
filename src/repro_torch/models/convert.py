"""Parameters from numpy: the bridge from the reference's weights.

``params_from_numpy`` takes a params tree whose leaves are numpy arrays
(for instance the reference ``ModelProgram.init`` output passed through
``np.asarray``) and returns the same tree of torch tensors on ``device``.
A ``bfloat16`` leaf (an ``ml_dtypes`` dtype, which plain numpy cannot
name) is reinterpreted through a 16-bit integer view, the same trick the
reference's checkpoint format uses, so this module needs no ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_numpy(tree, device=None):
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)
