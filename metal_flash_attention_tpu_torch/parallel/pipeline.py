"""Pipeline parallelism: GPipe microbatches over a stage axis.

The port of the JAX package's `parallel/pipeline.py`.  A layer stack is
split into ``n_stages`` groups whose parameters are stacked on a leading
stage dim (`stack_stage_params`) and cut over the stage axis
(`stage_param_sharding`, `parallel.mesh.shard`): each rank (one process
a stage, SPMD) holds its stage's block.  At step t a stage works on
microbatch t - stage, so the pipe fills for n_stages - 1 steps (the
GPipe bubble, a share (S - 1) / (M + S - 1) of the steps for S stages
and M microbatches), streams, then drains.

Activations move stage to stage by `parallel.mesh.ring_shift` (JAX's
`ppermute` (i, (i + 1) % n)), a `torch.autograd.Function` whose
backward sends each gradient the other way, so the backward pipeline
runs through autograd as JAX's does through `jax.grad`.  Every rank runs
the same steps on the same shapes, as JAX's SPMD program does (a stage
in its bubble computes on zeros or a repeated microbatch, and nothing of
it reaches an output), so every rank's autograd graph has the same
hops in the same order and the ranks' backward sends pair up.

The last stage's outputs are made whole on every rank by the port's rule
for a whole tensor (`row_parallel_sum` over the stage axis: a float32
sum forward, the gradient passed through backward), and the input
microbatches, whole on every rank, carry the whole loss's gradient
(`column_parallel_input`): the gradients equal the sequential chain's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from metal_flash_attention_tpu_torch.parallel.mesh import (
    STAGE_AXIS,
    P,
    axis_index,
    axis_size,
    column_parallel_input,
    ring_shift,
    row_parallel_sum,
)
from metal_flash_attention_tpu_torch.utils.tree import flatten, tree_map


def make_pipeline_mesh(n_stages: int, devices: Optional[str] = None):
    """A `DeviceMesh` with the one dim "stage" over the process group,
    which must already be initialised with exactly ``n_stages`` ranks
    (JAX takes a prefix of `jax.devices()`).  ``devices``: "cuda" (the
    default) or "cpu" (gloo), as `parallel.mesh.make_mesh`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if devices is None else devices
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"devices must be 'cuda' or 'cpu', got "
                         f"{devices!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_pipeline_mesh: no CUDA device (pass "
                           "devices='cpu' for a CPU mesh)")
    if int(n_stages) != n_stages or n_stages < 1:
        raise ValueError(f"n_stages must be a positive integer, got "
                         f"{n_stages}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_pipeline_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    if dist.get_world_size() != n_stages:
        raise ValueError(f"{n_stages} stages need {n_stages} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, (n_stages,),
                            mesh_dim_names=(STAGE_AXIS,))


def stack_stage_params(per_stage_params: list):
    """[stage 0's tree, stage 1's, ...] -> one tree whose leaves have a
    leading stage dim."""
    leaves = [flatten(t)[0] for t in per_stage_params]
    _, rebuild = flatten(per_stage_params[0])
    return rebuild([torch.stack(xs) for xs in zip(*leaves)])


def stage_param_sharding(params_stacked, mesh) -> object:
    """A `PartitionSpec` per leaf putting the leading (stage) dim on the
    stage axis: P("stage", None, ...), for `parallel.mesh.shard`."""
    del mesh
    return tree_map(lambda x: P(STAGE_AXIS, *[None] * (x.dim() - 1)),
                    params_stacked)


def pipeline(stage_fn: Callable, params_local, x: torch.Tensor, *, mesh,
             axis: str = STAGE_AXIS) -> torch.Tensor:
    """Run x through the pipelined stage stack.

    ``stage_fn(stage_params, activation [mb, ...]) -> activation`` is one
    stage's computation (a group of transformer layers, say) and keeps
    the activation's shape and dtype.  ``params_local``: this rank's
    block of the stacked parameters, leading dim 1 (`shard` under
    `stage_param_sharding`).  ``x`` [n_microbatches, mb, ...], whole on
    every rank.  ``mesh``: a DeviceMesh with the dim ``axis``.  Returns
    [n_microbatches, mb, ...] outputs, whole on every rank.  Every rank
    of the axis calls it, and (through autograd) its backward."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no {axis!r} dim: "
                         f"{mesh.mesh_dim_names}")
    n_stages, stage = axis_size(mesh, axis), axis_index(mesh, axis)
    n_micro = x.shape[0]
    params = tree_map(lambda p: p[0], params_local)
    xs = column_parallel_input(x, mesh, axis)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    carry = torch.zeros_like(xs[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        # Stage 0 takes microbatch t (the last one again once they run
        # out); the others take what the previous stage sent.  Both enter
        # the graph on every rank, so that every rank's backward makes
        # the same hops.
        y = stage_fn(params, torch.where(first, xs[min(t, n_micro - 1)],
                                         carry))
        if t >= n_stages - 1:
            outs.append(y.to(x.dtype))
        if t < n_micro + n_stages - 2:
            carry = ring_shift(y, mesh, axis)
    # Only the last stage holds the outputs; the others add zeros (their
    # own steps stay in the graph, with zero gradients, as above).
    out = torch.where(last, torch.stack(outs), torch.zeros_like(x))
    return row_parallel_sum(out, mesh, axis)
