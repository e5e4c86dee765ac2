"""Device meshes over ``torch.distributed``: one process a rank.

Counterpart of ``repro.launch.mesh``, with the reference's shapes and
axis names:

  Single pod : (16, 16)      axes ("data", "model")
  Multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")
  Test       : (4, 2) and (2, 2, 2) of the same names

Each is a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group the caller initialized (``torch.distributed.init_process_group``,
with its address, world size and rank given: nothing here finds a
cluster).  The world size must be the mesh's size.  Every axis's process
group is created with ``timeout``, so that a rank that diverges fails its
peers' next collective instead of hanging them.  The caller names the
device type: nothing here picks the CPU when it finds no card.

The ``fake`` backend (``init_fake_world``) takes no timeout: the dry run
(``launch.dryrun``) runs one rank's program over it, without a peer.

``gloo`` ranks that share a card (NCCL refuses two ranks on one GPU)
take CUDA tensors in c10d's collectives, copied through the host inside
``gloo``, but its functional ``all_gather_into_tensor`` on CUDA tensors
ends the process with a segmentation fault (torch 2.11).  DTensor's
redistributions run on those functional collectives, so a ``gloo`` mesh
on the card makes them copy their operands to the host, run there and
copy the result back (``_stage_functional_collectives``): the same bytes
``gloo`` would copy, the same sums.
"""
from __future__ import annotations

import datetime
import math

import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)

# the functional collectives DTensor's redistributions call (the names of
# torch 2.11 and of later releases)
_STAGED = ("all_gather_tensor", "all_gather_single", "reduce_scatter_tensor",
           "reduce_scatter_single", "all_reduce", "all_to_all_single")


def _staged(fn):
    def on_host(tensor, *args, **kwargs):
        if not tensor.is_cuda:
            return fn(tensor, *args, **kwargs)
        out = fn(tensor.detach().cpu(), *args, **kwargs)
        if hasattr(out, "wait"):
            out = out.wait()
        return out.to(tensor.device)
    on_host.__wrapped__ = fn
    return on_host


def _stage_functional_collectives():
    """Route the functional collectives of CUDA tensors through the host
    (a ``gloo`` mesh on the card; see the module docstring)."""
    import torch.distributed._functional_collectives as funcol
    for name in _STAGED:
        fn = getattr(funcol, name, None)
        if fn is not None and not hasattr(fn, "__wrapped__"):
            setattr(funcol, name, _staged(fn))


def _options(backend: str, timeout: datetime.timedelta):
    if backend == "fake":
        return None
    if backend == "nccl":
        opts = tdist.ProcessGroupNCCL.Options()
    elif backend == "gloo":
        opts = tdist.ProcessGroupGloo._Options()
    else:
        raise ValueError(f"backend {backend!r}: the mesh takes nccl, gloo "
                         f"or fake")
    opts._timeout = timeout
    return opts


def make_mesh(shape, axis_names, *, device_type: str,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the world
    process group, each axis's group on its backend with ``timeout``."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} axis sizes for {len(axis_names)} "
                         f"axis names")
    if not tdist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed initialized "
                           "first (init_process_group: one process a rank)")
    world = tdist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {world}")
    backend = tdist.get_backend()
    if backend == "gloo" and device_type == "cuda":
        _stage_functional_collectives()
    opts = _options(backend, timeout)
    override = None if opts is None else \
        {a: (backend, opts) for a in axis_names}
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names,
                            backend_override=override)


def init_fake_world(world_size: int) -> None:
    """This process as rank 0 of a fake process group of
    ``world_size`` ranks (``torch.testing``'s ``FakeProcessGroup``): every
    collective returns at once without moving data, so that one process
    can run one rank's program on a mesh of any size (the dry run's, on
    ``meta`` tensors).  A process group already initialized must be a
    fake one of that size."""
    if tdist.is_initialized():
        if tdist.get_backend() != "fake" or \
                tdist.get_world_size() != world_size:
            raise RuntimeError(
                f"a {tdist.get_backend()} process group of "
                f"{tdist.get_world_size()} ranks is initialized; the dry "
                f"run needs a fake one of {world_size}")
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise ImportError(
            "the fake process group needs the module "
            "torch.testing._internal.distributed.fake_pg") from e
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda",
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type, timeout=timeout)


def make_test_mesh(*, multi_pod: bool = False, device_type: str,
                   timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """The scaled-down mesh of eight ranks."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type, timeout=timeout)
