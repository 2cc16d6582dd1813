"""Tiny shared arithmetic helpers."""


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x (TPU tile/lane padding)."""
    return ((x + m - 1) // m) * m
