"""The whole step's share of the card's bf16 peak in the physmamba cells,
read as ``step_mfu`` reads it: the net's operations a call (the system's
``net_flops``, PhysMamba's analytic count) times the window's completed
calls, over the untraced window's seconds times 989 TFLOP/s."""

from gpubench.metrics import step_mfu


def read(run):
    return step_mfu.read(run)
