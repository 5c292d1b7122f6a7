"""Weights from the reference package: ``params_from_jax`` turns the JAX
runner's params pytree (fetched to the host as numpy, nested dicts and
lists) into this package's params, so both packages compute with
identical weights.  Every leaf keeps its dtype (bf16 leaves arrive as
``ml_dtypes.bfloat16`` numpy arrays and stay bf16); the packed kernel
weights (``trunk``, ``stem_wmat``) and a stand-in's packed stem twin
``stem_p`` carry over as they are.  A compiled TFLite graph's params (a
landmark net, a detector or the segmenter) are one flat dict and carry
across key for key: the constants ``"{idx}:{name}"`` (integer shape
operands included, the stacked ``bnc_*`` weights of the chained
bottleneck stages, the composed ``fused_dwpw_*`` and packed ``s2d_*``
weights of the graph passes), the split-off stem ``__stem__:w/b/alpha``
and its packed matrix ``__stem_wmat__``.

``mlp_params_from_numpy`` does the same for the BP head: the reference's
``MLPParams`` (fetched as numpy) -> this package's, so both compute the
same head.
"""

from __future__ import annotations

import numpy as np
import torch


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
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)


def mlp_params_from_numpy(params, device="cpu"):
    """The reference's ``MLPParams`` (weights and biases as numpy arrays)
    -> this package's ``train.bp_regressor.MLPParams`` of f32 tensors on
    ``device``."""
    from bp_from_video_tpu_torch.train.bp_regressor import MLPParams

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return MLPParams(tuple(t(w) for w in params.weights),
                     tuple(t(b) for b in params.biases))
