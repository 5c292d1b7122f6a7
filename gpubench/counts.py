"""The yardstick's arithmetic: the card's published peaks, each kernel
launch's operations and bytes from its shape, and the nets' operations
from their architecture.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
rates): 3.35 TB/s HBM, 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
f32 outside them (``chip_smoke.py``'s ``bound_ms`` constants).

A kernel launch is listed in the configuration file by its shape per crop
of one net; the batch is the cell's crops of that net a call (the
system's ``batch_of``).  Operations are those the layer needs (a depthwise
3x3 then a pointwise conv counts as such, not as the dense conv the kernel
composes them into); bytes count each input and weight byte read once and
each output byte written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
BF16, F32 = 2, 4


def bound_s(nbytes: float, flops: float, peak_flops: float = BF16_TENSOR_FLOPS
            ) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def crops_per_call(net: str, streams: int, frames_per_call: int,
                   max_hands: int) -> int:
    """Crops of ``net`` an engine call feeds its landmark or detector
    batch."""
    per = max_hands if net == "hand_lm" else 1
    return streams * frames_per_call * per


def dense_s2_block(b: int, cin: int, cout: int, out_hw: int, conv: str
                   ) -> tuple[float, float]:
    """(operations, bytes) of one K3 launch over ``b`` crops: a 3x3
    stride-2 conv (``conv`` "dense": a stem) or a blaze block (``conv``
    "dwpw": depthwise 3x3/2, pointwise, max-pool residual; the residual
    re-reads the input, counted once) at output ``out_hw`` squared, bf16
    activations and weights, f32 biases."""
    px = b * out_hw * out_hw
    if conv == "dense":
        flops = 2.0 * px * cout * cin * 9
        wbytes = 9 * cin * cout * BF16 + cout * F32
    elif conv == "dwpw":
        flops = 2.0 * px * (cin * 9 + cin * cout)
        wbytes = (9 * cin + cin * cout) * BF16 + (cin + cout) * F32
    else:
        raise ValueError(f"unknown conv {conv!r}")
    nbytes = (b * cin * (2 * out_hw) ** 2 * BF16 + px * cout * BF16
              + wbytes)
    return flops, nbytes


def bottleneck_chain(b: int, c: int, d: int, hw: int, units: int
                     ) -> tuple[float, float]:
    """(operations, bytes) of one K6 call over ``b`` crops: ``units``
    stride-1 bottleneck units (1x1 c->d, PReLU, depthwise 3x3, 1x1 d->c,
    residual add, PReLU) at ``hw`` squared, in one pass: the input read
    once, the output written once, every unit's weights read once."""
    px = b * hw * hw
    flops = 2.0 * px * units * (c * d + 9 * d + d * c)
    wbytes = units * ((c * d + 9 * d + d * c) * BF16
                      + (d + d + c + d + c) * F32)
    nbytes = 2 * px * c * BF16 + wbytes
    return flops, nbytes


KERNELS = {"dense_s2_block": dense_s2_block,
           "bottleneck_chain": bottleneck_chain}


def kernel_bound_s(fn, launches: list[dict], batch) -> float:
    """Sum of the least times of one call's launches of one kernel, as
    listed (``{"net", **shape}`` per launch): ``fn(b, **shape)`` gives a
    launch's (operations, bytes), ``batch(net)`` its batch ``b``."""
    total = 0.0
    for launch in launches:
        shape = dict(launch)
        flops, nbytes = fn(batch(shape.pop("net")), **shape)
        total += bound_s(nbytes, flops)
    return total


def net_flops(ref, crops: dict) -> float:
    """Operations of one call's nets: each net of ``crops`` ({runner key:
    crops a call}) run once at batch 1 on the reference (float32, plain),
    counted by ``torch.utils.flop_counter`` (convolutions and products,
    2 per multiply-add), times its crops."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from gpubench.ref.models import blaze
    run, params = ref.runner, ref.params
    dev = ref.device
    total = 0.0
    for key, n in crops.items():
        size = run.sizes[key]
        x = torch.full((1, 3, size, size), 0.5, device=dev)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            if key in run._graph_fns:
                run._graph_fns[key](params[key], x)
            else:
                blaze.blaze_landmark_apply(params[key], x, size)
        total += fc.get_total_flops() * n
    return float(total)
