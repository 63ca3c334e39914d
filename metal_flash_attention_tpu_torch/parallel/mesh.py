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
  it compares entry by entry with JAX's `PartitionSpec`.  Its names are
  the three axes and the pipeline's `STAGE_AXIS`;
- `NamedSharding(mesh, spec)`, as the engine's ``kv_sharding`` takes it;
- `shard(tree, specs, mesh)`, the counterpart of `jax.device_put(tree,
  shardings)`: each leaf sliced to this rank's block (on a `make_mesh`
  mesh or a pipeline's, `parallel.pipeline.make_pipeline_mesh`);
- `unshard(x, spec, mesh)`: a block all-gathered back to the global
  tensor (for checks and tests);
- the collectives GSPMD inserts around the sharded products of the JAX
  package, each a `torch.autograd.Function`, so that training
  differentiates through them as `jax.grad` does through XLA's:
  - `column_parallel_input`: the input of a column-parallel product,
    identity forward, its gradient summed over the heads axis backward;
  - `row_parallel_sum`: a row-parallel product's partials summed over
    the heads axis forward, the gradient passed through backward;
  - `gather_columns`: a column-parallel block gathered whole forward,
    this rank's columns of the gradient backward;
  - `data_replicated` and `data_mean`: a parameter at its use in a
    data-parallel loss (identity forward, its gradient averaged over the
    data axis backward) and the loss itself (the mean over the data axis
    forward, this rank's own gradient backward), so that every
    gradient of a data group comes out as the global batch's mean; with
    ``context=True`` the average runs over the data and context axes
    together (a context rank holds an equal share of the tokens);
  - `sum_over` (a sum whose gradient is summed too) and `gather_rows`
    (an integer tensor's rows gathered), for MoE routing over the data
    axis;
  - `ring_shift`: a tensor sent to the next rank of an axis and the
    previous rank's received (JAX's `ppermute` with the perm
    ``(i, (i + 1) % n)``), the gradient sent back the other way: the
    pipeline's stage-to-stage hop.
- `ring_permute` / `start_ring_permute`: the same hop for a list of
  tensors without a gradient (ring attention's K/V and dK/dV), by
  `torch.distributed.batch_isend_irecv` over the axis's group; the
  second returns at once, with a ``wait()`` that gives the received
  tensors, so a caller overlaps the hop with its kernels.

Gradients follow one rule: on a rank, a tensor whole over an axis carries
the gradient of the whole loss, and a block carries its own block's.

Every sum runs in float32 and is cast back once, so the only extra
rounding against one card is that of each partial (JAX's GSPMD psum adds
bf16 partials in bf16).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
HEAD_AXIS = "heads"
CONTEXT_AXIS = "context"
AXES = (DATA_AXIS, HEAD_AXIS, CONTEXT_AXIS)
# The pipeline mesh's one axis (`parallel.pipeline`).
STAGE_AXIS = "stage"
SPEC_AXES = AXES + (STAGE_AXIS,)


class PartitionSpec(tuple):
    """How a tensor lies over the mesh: an axis name or None per
    dimension (trailing dimensions left out are None)."""

    def __new__(cls, *axes):
        for a in axes:
            if a is not None and a not in SPEC_AXES:
                raise ValueError(f"not a mesh axis: {a!r} (the axes are "
                                 f"{SPEC_AXES})")
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


def check_mesh(mesh, dims=(AXES,)):
    """``mesh`` if it is a `make_mesh` mesh (or one whose dim names are
    another tuple of ``dims``); TypeError for anything that is not a
    DeviceMesh, ValueError for one with other dims."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh from make_mesh, got "
                        f"{type(mesh).__name__}")
    if tuple(mesh.mesh_dim_names or ()) not in dims:
        raise ValueError(f"mesh dims must be one of {dims}, got "
                         f"{mesh.mesh_dim_names}")
    return mesh


# The meshes `shard` and `unshard` take: make_mesh's and a pipeline's.
_SHARD_DIMS = (AXES, (STAGE_AXIS,))


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's block index along ``axis`` (`jax.lax.axis_index`)."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def block_slices(shape, spec, mesh) -> tuple:
    """This rank's block of a tensor of ``shape`` under ``spec``: one
    slice per dimension (ValueError where an axis does not divide its
    dimension)."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{len(shape)} dims")
    out = [slice(None)] * len(shape)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if n == 1:
            continue
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of size {shape[dim]} does not "
                             f"split over {n} ranks of {axis!r}")
        size = shape[dim] // n
        start = axis_index(mesh, axis) * size
        out[dim] = slice(start, start + size)
    return tuple(out)


def _block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    where = block_slices(x.shape, spec, mesh)
    if all(s == slice(None) for s in where):
        return x
    # A block owns its memory, so the global tensor can be freed.
    return x[where].clone(memory_format=torch.contiguous_format)


def shard(tree, specs, mesh):
    """This rank's block of every leaf of ``tree`` (dicts, lists and
    tuples of tensors) under the matching leaf of ``specs`` (the same
    structure, `PartitionSpec` leaves, as `param_shardings` returns).
    Replicated leaves come back as they are; a split leaf comes back as a
    contiguous copy of its block.  The counterpart of `jax.device_put(
    tree, shardings)`."""
    check_mesh(mesh, _SHARD_DIMS)

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
    check_mesh(mesh, _SHARD_DIMS)
    for dim, axis in enumerate(tuple(spec)):
        if axis is None:
            continue
        parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
        dist.all_gather(parts, x.contiguous(),
                        group=axis_group(mesh, axis))
        x = torch.cat(parts, dim=dim)
    return x


def _whole(mesh, axis: str) -> bool:
    """No mesh, or one rank on ``axis``: every collective over it is the
    identity and is skipped."""
    return mesh is None or axis_size(mesh, axis) == 1


def _sum(t: torch.Tensor, mesh, axis, mean: bool = False
         ) -> torch.Tensor:
    """``t`` summed (``mean``: averaged) over ``axis`` (a name, or a
    tuple of names: one all-reduce an axis) in float32 (or t's wider
    type), cast back to t's dtype; t itself is left as it was."""
    axes = (axis,) if isinstance(axis, str) else axis
    total = t.to(torch.promote_types(t.dtype, torch.float32), copy=True)
    for a in axes:
        dist.all_reduce(total, group=axis_group(mesh, a))
    if mean:
        total /= math.prod(axis_size(mesh, a) for a in axes)
    return total.to(t.dtype)


class _Replicated(torch.autograd.Function):
    """Identity forward; the gradient summed (``mean``: averaged) over
    ``axis`` backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        ctx.mesh, ctx.axis, ctx.mean = mesh, axis, mean
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis, ctx.mean), None, None, None


class _Reduced(torch.autograd.Function):
    """Summed (``mean``: averaged) over ``axis`` forward; the gradient
    passed through backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        return _sum(x, mesh, axis, mean)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, mesh, axis):
        ctx.index, ctx.width = axis_index(mesh, axis), block.shape[-1]
        parts = [torch.empty_like(block)
                 for _ in range(axis_size(mesh, axis))]
        dist.all_gather(parts, block.contiguous(),
                        group=axis_group(mesh, axis))
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None


def column_parallel_input(x: torch.Tensor, mesh,
                          axis: str = HEAD_AXIS) -> torch.Tensor:
    """``x``, whole on every rank of ``axis``, as the input of this rank's
    column block of a product: the same values, and in the backward the
    ranks' partial gradients summed over ``axis`` (each rank's block
    sees only its own columns' share).  Without a mesh, or with one rank
    on ``axis``, x itself."""
    if _whole(mesh, axis):
        return x
    return _Replicated.apply(x, mesh, axis, False)


def row_parallel_sum(partial: torch.Tensor, mesh,
                     axis: str = HEAD_AXIS) -> torch.Tensor:
    """Sum a row-parallel product's per-rank partials over ``axis``.

    Each rank's partial (in the model dtype, as its product left it) is
    summed in float32 and the sum cast back to the partial's dtype, so
    the only extra rounding against one card is that of each partial.
    The gradient passes through unchanged: the sum is whole on every
    rank, and so is its gradient.  Without a mesh the partial is the
    whole product and comes back as it is, as it does with one rank on
    ``axis``."""
    if _whole(mesh, axis):
        return partial
    return _Reduced.apply(partial, mesh, axis, False)


def gather_columns(block: torch.Tensor, mesh,
                   axis: str = HEAD_AXIS) -> torch.Tensor:
    """A column-parallel product's blocks [..., n / size] -> the whole
    [..., n] on every rank (the last dim all-gathered over ``axis``); the
    gradient of the whole, the same on every rank, goes back as this
    rank's columns."""
    if _whole(mesh, axis):
        return block
    return _GatherColumns.apply(block, mesh, axis)


def sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Each rank's ``x`` summed over ``axis`` (float32), with the
    gradient summed over ``axis`` too: for a sum whose ranks each take a
    share of the same loss (MoE's load-balancing means over the data
    axis)."""
    if _whole(mesh, axis):
        return x
    return _SumOver.apply(x, mesh, axis)


def gather_rows(x: torch.Tensor, mesh, axis: str = DATA_AXIS
                ) -> torch.Tensor:
    """The ranks' ``x`` (no gradient) concatenated along dim 0 in rank
    order: a tensor split on its rows over ``axis`` made whole."""
    if _whole(mesh, axis):
        return x
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=axis_group(mesh, axis))
    return torch.cat(parts, dim=0)


def _batch_axes(mesh, context: bool) -> tuple:
    """The axes of more than one rank whose ranks hold shares of the
    batch's tokens: data, and with ``context`` the context axis."""
    axes = (DATA_AXIS, CONTEXT_AXIS) if context else (DATA_AXIS,)
    return tuple(a for a in axes if not _whole(mesh, a))


def data_replicated(tree, mesh, *, context: bool = False):
    """Every tensor of ``tree`` (a parameter tree) as its use in a
    data-parallel loss sees it: the same values, and in the backward
    its gradient averaged over the data axis (with ``context``, over the
    data and context ranks together: one float32 all-reduce an axis of
    more than one rank, then one division).  Every rank of a data group
    then holds the gradient of the mean over the global batch (the JAX
    package's loss), so an optimizer step keeps the group's copies
    equal.  Without a mesh, or with one rank on those axes, ``tree``
    itself."""
    axes = _batch_axes(mesh, context)
    if not axes:
        return tree
    from metal_flash_attention_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: _Replicated.apply(t, mesh, axes, True), tree)


def data_mean(loss: torch.Tensor, mesh, *, context: bool = False
              ) -> torch.Tensor:
    """A data rank's loss over its rows -> the mean over the data axis
    (with ``context``, over the data and context ranks: each holds an
    equal share of the tokens, so it is the global batch's mean), whose
    gradient is this rank's own loss's: with `data_replicated`
    parameters, the averaging happens once, on the gradients.  Without a
    mesh, or with one rank on those axes, ``loss`` itself."""
    axes = _batch_axes(mesh, context)
    if not axes:
        return loss
    return _Reduced.apply(loss, mesh, axes, True)


def start_ring_permute(tensors, mesh, axis: str, shift: int = 1):
    """Send each tensor of ``tensors`` to the rank ``shift`` places on
    along ``axis`` (cyclically) and receive the same number from the rank
    ``shift`` places back, by one `torch.distributed.batch_isend_irecv`
    over the axis's group (peers named by their global ranks).  Returns
    at once with ``wait()``, which blocks (on the card: makes the current
    stream wait) and gives the received tensors, each shaped and typed as
    the one sent.  The sent tensors must not change until then.  With
    one rank on ``axis``, ``wait()`` gives the tensors themselves."""
    tensors = [t.contiguous() for t in tensors]
    if _whole(mesh, axis):
        return lambda: tensors
    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    me = axis_index(mesh, axis)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, src, group) for r in received]
    requests = dist.batch_isend_irecv(ops)

    def wait():
        for r in requests:
            r.wait()
        return received
    return wait


def ring_permute(tensors, mesh, axis: str, shift: int = 1) -> list:
    """The counterpart of JAX's `ppermute` with the perm ``(i, (i + shift)
    % n)``: each tensor sent to the next rank of ``axis``, the previous
    rank's returned (`start_ring_permute`, waited for).  No gradient."""
    return start_ring_permute(tensors, mesh, axis, shift)()


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return ring_permute([x], mesh, axis)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_permute([g], ctx.mesh, ctx.axis, shift=-1)[0], None, None


def ring_shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` sent to the next rank of ``axis``, the previous rank's
    returned, differentiably: the gradient goes back to the rank that
    sent it (a hop the other way).  Every rank of the axis calls it, in
    the forward and, through autograd, in the backward.  With one rank on
    ``axis``, x itself."""
    if _whole(mesh, axis):
        return x
    return _RingShift.apply(x, mesh, axis)
