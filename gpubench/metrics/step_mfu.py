"""The whole step's share of the card's bf16 peak: the nets' operations a
call (counted from each net's architecture at its input size, for the nets
the cell's traffic runs) times the window's completed calls, over the
untraced window's seconds on the host clock times 989 TFLOP/s."""

from gpubench import counts


def read(run):
    if not run.flops_per_call:
        return None
    w = run.window
    return 100.0 * run.flops_per_call * (w.calls - w.failed_calls) / (
        w.window_s * counts.BF16_TENSOR_FLOPS)
