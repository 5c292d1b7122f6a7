"""Weights from the reference package: ``params_from_jax`` turns the JAX
runner's params pytree (fetched to the host as numpy, nested dicts and
lists) into this package's params, so both packages compute with
identical weights.  Every leaf keeps its dtype (bf16 leaves arrive as
``ml_dtypes.bfloat16`` numpy arrays and stay bf16); the packed kernel
weights (``trunk``, ``stem_wmat``) carry over as they are, and the packed
stem twin ``stem_p``, which only the unfused packed path reads, is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

_DROP = ("stem_p",)


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16
                                                         ).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device="cpu"):
    """Nested dict/list of numpy arrays (the JAX runner's ``params``) ->
    the same structure of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()
                if k not in _DROP}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)
