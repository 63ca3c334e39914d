"""The error for a JAX feature the port does not have yet."""

from __future__ import annotations

# The port queue's item for what is refused on a mesh: a context axis of
# more than one rank in the training paths (ring and zigzag attention with
# their backward) and the pipeline.
SHARDED_TRAINING = "sharded training"


def not_ported(what: str, item: str) -> NotImplementedError:
    """``item`` names the feature's entry in ROADMAP.md's port queue."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, port queue: {item})")
