"""The error for a JAX feature the port does not have yet."""

from __future__ import annotations


def not_ported(what: str, item: str) -> NotImplementedError:
    """``item`` names the feature's entry in ROADMAP.md's port queue."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, port queue: {item})")
