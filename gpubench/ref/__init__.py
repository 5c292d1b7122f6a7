"""The plain reference of the benchmark: a frozen copy of the port's plain
path (``bp_from_video_tpu_torch`` at commit b61bbd7: config, models, ops
and the engine), imports rewritten to this package and trimmed to what the
benchmark's configurations run.

It runs in float32 with no kernel route at all: crops are separable
resamples, the compiled face mesh runs op by op with no graph pass, the
hand stand-in as plain convolutions, ROI sampling as the plain masked
sums, the DSP as the Butterworth band-pass and the Lomb-Scargle spectrum.
It follows tracked streams only (no detector).  Nothing here imports the
port, the JAX package or JAX; later changes to the port do not reach it.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu'")
    return dev
