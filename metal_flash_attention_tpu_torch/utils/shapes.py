"""Integer shape helpers (ceil division, rounding up).

The JAX package also pads arrays to TPU tile multiples here; the port
keeps tensors at their true shapes, so only the integer helpers remain.
"""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
