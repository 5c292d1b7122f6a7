"""PyTorch + CUDA port of ``bp_from_video_tpu`` (rPPG heart rate and pulse
transit time from video).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's layout and semantics.  The package imports ``torch`` and
``numpy`` only.  Each TPU (Pallas) kernel on the ported path has a
hand-written CUDA kernel under ``csrc/`` with its wrapper and plain PyTorch
version under ``kernels/``: a CUDA tensor launches the kernel (or raises),
a CPU tensor takes the plain version.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """Entry-point device policy: ``None`` means ``"cuda"``.  Raises when
    CUDA is requested but absent — the CPU runs only when asked for
    explicitly (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
