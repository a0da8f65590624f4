"""Operand bits of every query the closed loop completed in the window,
over the whole window (a query of k operands of n bits counts k * n)."""


def read(rec):
    if rec["loop"] != "closed":
        return None
    return rec["operand_bits"] / rec["window_s"] / 1e9
