"""Multi-device env-axis sharding.

Port of test_isaacgym_tpu/parallel/mesh.py. The reference has exactly one
parallelism axis, the env batch (SURVEY.md §2.4). Here envs shard over the
ranks of `torch.distributed`, one process a device: NCCL between cards, gloo
on the CPU. The mesh is a `DeviceMesh` ('env' axis, or ('dcn', 'ici') when
2-D), used for its process groups.

Each rank holds plain local tensors, its contiguous slice of every leaf
whose leading dim is the env count (not DTensors: an eager step is thousands
of small ops, and the ctypes kernel and advanced indexing have no sharding
rule). The step is elementwise over envs, so a rank steps its shard with no
collective; the observation gather to a learner and the metric sums are the
only collectives, at the loop boundary.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

# a hung peer fails the run instead of blocking it
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _tree_map(fn, tree):
    """fn over the leaves of a tree of NamedTuples, tuples, lists and dicts;
    None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _axes(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _is_env_leaf(x, num_envs: int) -> bool:
    return getattr(x, "ndim", 0) >= 1 and x.shape[0] == num_envs


def _shard_index(mesh: DeviceMesh, axis):
    """(this rank's shard index, shard count) along `axis`: a tuple of mesh
    dims shards over all of them, the first outermost, so on a ('dcn',
    'ici') mesh the index is dcn_idx * ici + ici_idx."""
    idx, count = 0, 1
    for name in _axes(axis):
        size = mesh.size(mesh.mesh_dim_names.index(name))
        idx = idx * size + mesh.get_local_rank(name)
        count *= size
    return idx, count


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _new_mesh(devices, shape, names) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call init_distributed with a coordinator (or run "
            "under torchrun) before making a mesh"
        )
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"devices must order every rank of the world of {world}, got {ranks}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


def make_env_mesh(devices=None, axis: str = "env") -> DeviceMesh:
    """1-D mesh over every rank of the process group. `devices`: the global
    ranks in the axis's order (default rank order)."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    return _new_mesh(devices, (world,), (axis,))


def make_2d_mesh(dcn: Optional[int] = None, ici: Optional[int] = None, devices=None) -> DeviceMesh:
    """2-D ('dcn', 'ici') mesh: the slow links between hosts as the OUTER
    axis, the fast ones within a host (NVLink) as the inner one, so the
    ranks of one host are neighbours on 'ici'. `dcn` defaults to the host
    count, world size // LOCAL_WORLD_SIZE. Env trees shard over both axes
    (axis=('dcn', 'ici'))."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if dcn is None:
        dcn = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world or 1)), 1)
    if ici is None:
        ici = world // dcn
    if dcn * ici != world:
        raise ValueError(f"dcn {dcn} x ici {ici} != world size {world}")
    return _new_mesh(devices, (dcn, ici), ("dcn", "ici"))


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device="cuda",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Multi-process entry: join the process group; returns this rank's
    device.

    `coordinator` is "host:port" of rank 0; without arguments torchrun's
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK are read. With no
    coordinator configured and one process it is a no-op, so the same script
    runs on one device and on many. `device` "cuda" takes NCCL on card
    LOCAL_RANK (or rank % cards), made current first; "cpu" takes gloo.
    There is no fallback: "cuda" without a card raises."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    dev = torch.device(device)
    if coordinator is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator address")
        return dev
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and process_id (or WORLD_SIZE, RANK)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for NCCL (pass device='cpu' for gloo)")
        index = dev.index
        if index is None:
            index = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for device {dev}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=timeout)
    return dev


def env_specs(tree, num_envs: int, axis="env"):
    """Placement tree: Shard(0) (along `axis`) for leaves whose leading dim
    is num_envs, Replicate() for the rest; None stays None."""
    return _tree_map(lambda x: Shard(0) if _is_env_leaf(x, num_envs) else Replicate(), tree)


def shard_env_tree(tree, mesh: DeviceMesh, num_envs: int, axis="env"):
    """This rank's copy of a full-width tree on its device: rows
    [r*n/R, (r+1)*n/R) of every env-leading leaf (env_specs), the other
    leaves whole. Every rank passes the same full tree (env construction is
    deterministic). Leaves may be tensors or numpy arrays."""
    r, count = _shard_index(mesh, axis)
    if num_envs % count:
        raise ValueError(f"{num_envs} envs do not split over {count} shards of {_axes(axis)}")
    n = num_envs // count
    dev = _mesh_device(mesh)

    def place(x):
        x = torch.as_tensor(x)
        if _is_env_leaf(x, num_envs):
            x = x[r * n:(r + 1) * n]
        return x.to(dev, copy=True)

    return _tree_map(place, tree)


# Every process holds only its own shard here, so the multi-process variant
# is the same function.
global_env_tree = shard_env_tree


def _check_local(mesh: DeviceMesh, axis, state, *trees) -> None:
    """Raise if a tree still holds a leaf at the global env count: the
    local step would mix an n/R-env shard with N-env data."""
    count = _shard_index(mesh, axis)[1]
    n_local = state.root_pos.shape[0]
    if count == 1:
        return
    for tree in (state, *trees):
        for x in _tree_leaves(tree):
            if _is_env_leaf(x, n_local * count):
                raise ValueError(
                    f"a leaf of shape {tuple(x.shape)} has the global env count "
                    f"{n_local * count}; pass shard_env_tree's local shards"
                )


def shard_step(step_fn, mesh: DeviceMesh, state, actions, params, axis="env"):
    """A step(state, actions, params) -> state on this rank's shards, as
    shard_env_tree made them from the example trees given here. Envs are
    independent, so the step holds no collective: it is step_fn itself."""
    _check_local(mesh, axis, state, actions, params)
    return step_fn


def gather_obs(obs: torch.Tensor, axis="env", *, mesh: DeviceMesh) -> torch.Tensor:
    """The learner gather: (n_local, ...) per-env observations ->
    (N, ...) in global env order on every rank. A tuple axis ('dcn', 'ici')
    gathers over the inner axis first, then the outer one."""
    x = obs.contiguous()  # obs such as body_pos[:, hand] are strided
    for name in reversed(_axes(axis)):
        group = mesh.get_group(name)
        out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        x = out
    return x


def obs_gather(obs: torch.Tensor, mesh: DeviceMesh, axis="env") -> torch.Tensor:
    """gather_obs with the JAX helper's argument order."""
    return gather_obs(obs, axis, mesh=mesh)


def rollout_with_obs(step_fn, obs_fn, mesh: DeviceMesh, state, actions, params,
                     num_steps: int, axis="env"):
    """Sharded rollout with the learner gather each step:

        num_steps x (state = step_fn(state); all_gather(obs_fn(state)))

    Returns fn(state, actions, params) -> (final local state, (num_steps,
    N, ...) obs replicated on every rank): 'sim shards produce, learner
    consumes' (BASELINE.json)."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    _check_local(mesh, axis, state, actions, params)

    def run(state, actions, params):
        traj = []
        for _ in range(num_steps):
            state = step_fn(state, actions, params)
            traj.append(gather_obs(obs_fn(state), axis, mesh=mesh))
        return state, torch.stack(traj)

    return run


def psum_metrics(tree, mesh: DeviceMesh, axis="env"):
    """Sum of each tensor leaf over the shards of `axis` (all_reduce), on
    every rank; the inputs are left as they were."""
    def reduce(x):
        x = x.clone()
        for name in _axes(axis):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(name))
        return x

    return _tree_map(reduce, tree)
