"""The device mesh on `torch.distributed`, and the sharding vocabulary.

The port of the JAX package's `parallel/mesh.py`, with the small pieces
of `jax.sharding` that the port's callers need.  JAX is single-controller:
one program sees global arrays that a `Mesh` has sharded.  The port is
SPMD: one process per card, each holding ITS OWN BLOCK of every sharded
tensor.  The names stay JAX's so that each counterpart is easy to find:

- `DATA_AXIS`, `HEAD_AXIS`, `CONTEXT_AXIS` and `make_mesh`, which returns
  a `torch.distributed.device_mesh.DeviceMesh` with those dim names;
- `PartitionSpec` (`P`): one entry per dimension of a tensor, an axis
  name (that dimension is split over the axis, rank i holding block i)
  or None (whole on every rank); ``P()`` replicates.  It is a tuple, so
  it compares entry by entry with JAX's `PartitionSpec`;
- `NamedSharding(mesh, spec)`, as the engine's ``kv_sharding`` takes it;
- `shard(tree, specs, mesh)`, the counterpart of `jax.device_put(tree,
  shardings)`: each leaf sliced to this rank's block;
- `unshard(x, spec, mesh)`: a block all-gathered back to the global
  tensor (for checks and tests);
- `row_parallel_sum` and `gather_columns`, the two collectives of
  tensor-parallel serving (the psum and the gather that GSPMD inserts
  around a row- and a column-parallel product in the JAX package).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
HEAD_AXIS = "heads"
CONTEXT_AXIS = "context"
AXES = (DATA_AXIS, HEAD_AXIS, CONTEXT_AXIS)


class PartitionSpec(tuple):
    """How a tensor lies over the mesh: an axis name or None per
    dimension (trailing dimensions left out are None)."""

    def __new__(cls, *axes):
        for a in axes:
            if a is not None and a not in AXES:
                raise ValueError(f"not a mesh axis: {a!r} (the axes are "
                                 f"{AXES})")
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh: JAX's `NamedSharding`."""
    mesh: object
    spec: PartitionSpec


def make_mesh(*, data: int = 1, heads: int = 1, context: int = 1,
              devices: Optional[str] = None):
    """A (data, heads, context) `DeviceMesh` over the process group.

    ``heads`` shards query heads and their KV heads (tensor-parallel
    serving, zero-communication attention), ``context`` the KV sequence
    (context parallelism), ``data`` the batch.  ``devices`` is the device
    type: "cuda" (the default; set each rank's card with
    `torch.cuda.set_device` first, and use the NCCL backend) or "cpu"
    (gloo).

    Departure from the JAX package: JAX builds its mesh from a prefix of
    `jax.devices()`.  Here every process is one rank, so the process
    group must already be initialised (`torch.distributed.
    init_process_group`, or `torchrun`) with exactly data * heads *
    context ranks; anything else raises."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if devices is None else devices
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"devices must be 'cuda' or 'cpu', got "
                         f"{devices!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass devices='cpu' "
                           "for a CPU mesh)")
    sizes = (data, heads, context)
    if any(int(n) != n or n < 1 for n in sizes):
        raise ValueError(f"axis sizes must be positive integers, got "
                         f"{sizes}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = data * heads * context
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {data}x{heads}x{context} needs {n} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, sizes, mesh_dim_names=AXES)


def check_mesh(mesh):
    """``mesh`` if it is a `make_mesh` mesh; TypeError for anything that
    is not a DeviceMesh, ValueError for one without the three axes."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh from make_mesh, got "
                        f"{type(mesh).__name__}")
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"mesh dims must be {AXES}, got "
                         f"{mesh.mesh_dim_names}")
    return mesh


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's block index along ``axis`` (`jax.lax.axis_index`)."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def _block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{x.dim()} dims")
    out = x
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {out.shape[dim]} does not "
                             f"split over {n} ranks of {axis!r}")
        size = out.shape[dim] // n
        out = out.narrow(dim, axis_index(mesh, axis) * size, size)
    # A block owns its memory, so the global tensor can be freed.
    return x if out is x else out.clone(memory_format=torch.contiguous_format)


def shard(tree, specs, mesh):
    """This rank's block of every leaf of ``tree`` (dicts, lists and
    tuples of tensors) under the matching leaf of ``specs`` (the same
    structure, `PartitionSpec` leaves, as `param_shardings` returns).
    Replicated leaves come back as they are; a split leaf comes back as a
    contiguous copy of its block.  The counterpart of `jax.device_put(
    tree, shardings)`."""
    check_mesh(mesh)

    def walk(t, s, path):
        if isinstance(s, PartitionSpec):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{path or 'tree'}: a spec for a "
                                f"{type(t).__name__}")
            return _block(t, s, mesh)
        if isinstance(t, dict) and isinstance(s, dict):
            if set(t) != set(s):
                raise ValueError(f"{path or 'tree'}: keys {sorted(t)} "
                                 f"against specs {sorted(s)}")
            return {k: walk(t[k], s[k], f"{path}/{k}") for k in t}
        if isinstance(t, (list, tuple)) and isinstance(s, (list, tuple)) \
                and len(t) == len(s):
            return type(t)(walk(a, b, f"{path}/{i}")
                           for i, (a, b) in enumerate(zip(t, s)))
        raise ValueError(f"{path or 'tree'}: structure differs from the "
                         f"specs")
    return walk(tree, specs, "")


def unshard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor from each rank's block ``x`` under ``spec``:
    an all-gather along every split dimension (a collective: every rank
    of the mesh calls it)."""
    check_mesh(mesh)
    for dim, axis in enumerate(tuple(spec)):
        if axis is None:
            continue
        parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
        dist.all_gather(parts, x.contiguous(),
                        group=axis_group(mesh, axis))
        x = torch.cat(parts, dim=dim)
    return x


def row_parallel_sum(partial: torch.Tensor, mesh,
                     axis: str = HEAD_AXIS) -> torch.Tensor:
    """Sum a row-parallel product's per-rank partials over ``axis``.

    Each rank's partial (in the model dtype, as its product left it) is
    summed in float32 and the sum cast back to the partial's dtype, so
    the only extra rounding against one card is that of each partial.
    Without a mesh the partial is the whole product and comes back as it
    is."""
    if mesh is None:
        return partial
    total = partial.float()
    dist.all_reduce(total, group=axis_group(mesh, axis))
    return total.to(partial.dtype)


def gather_columns(block: torch.Tensor, mesh,
                   axis: str = HEAD_AXIS) -> torch.Tensor:
    """A column-parallel product's blocks [..., n / size] -> the whole
    [..., n] on every rank (the last dim all-gathered over ``axis``)."""
    if mesh is None:
        return block
    parts = [torch.empty_like(block) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, block.contiguous(), group=axis_group(mesh, axis))
    return torch.cat(parts, dim=-1)
