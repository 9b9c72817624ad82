"""Process setup of a sharded run over several processes (the
``pyabc_tpu/parallel/distributed.py`` counterpart, over
``torch.distributed``).

Every process runs the SAME ABCSMC program with the same seed and
configuration; the processes form one process group and a one-dimensional
``DeviceMesh`` over it, and ``ABCSMC(..., mesh=global_mesh(), sharded=n)``
runs n/w of the run's n shards on each of the w processes. A generation's
only collective is its gather: everything between two gathers is local to
a rank, everything after one is replicated on every rank, so the ranks stay
in lock-step without a broker. Only the primary persists to a real
database: ``ABCSMC.new`` gives every other rank a throwaway in-memory
store, whatever url it is passed (``primary_db`` is the same rule for
storage a caller opens itself).

Usage (one process a device, identical code on each)::

    from pyabc_tpu_torch.parallel import distributed as dist

    dist.initialize("tcp://localhost:29511", num_processes=2,
                    process_id=rank)          # or the env, below
    mesh = dist.global_mesh()                 # "cuda"; "cpu" for Gloo tests
    abc = pt.ABCSMC(model, prior, ..., mesh=mesh, sharded=8, seed=0)
    abc.new("sqlite:///run.db", obs)          # written by the primary only
    abc.run(max_nr_populations=10)

The collectives run over Gloo; on the card a gather is staged through
pinned host memory. NCCL needs one card a rank, and a mesh over an NCCL
group is refused by ``ABCSMC``.
"""
from __future__ import annotations

import datetime
import os

import torch.distributed as dist


class DistributedConfigError(RuntimeError):
    """A multi-process configuration error caught before it reaches
    ``torch.distributed``: a partial configuration (an address without a
    process count, or the reverse) and a conflicting re-initialization."""


#: the config of the one successful :func:`initialize` call (None until
#: then): a second call with the same config is a no-op, one with another
#: config a typed error
_INIT_CONFIG: dict | None = None


def _resolve_init_config(coordinator_address, num_processes, process_id, *,
                         backend: str) -> dict:
    """Merge explicit arguments with the PYABC_TPU_* env fallbacks and
    reject partial configurations with a typed error."""
    coordinator_address = coordinator_address or os.environ.get(
        "PYABC_TPU_COORDINATOR")
    if num_processes is None and "PYABC_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PYABC_TPU_NUM_PROCESSES"])
    if process_id is None and "PYABC_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PYABC_TPU_PROCESS_ID"])
    explicit = {
        "coordinator_address": coordinator_address,
        "num_processes": num_processes,
        "process_id": process_id,
    }
    given = {k for k, v in explicit.items() if v is not None}
    if given and given != set(explicit):
        missing = sorted(set(explicit) - given)
        raise DistributedConfigError(
            "partial multi-process configuration: "
            f"{sorted(given)} set but {missing} missing — pass all of "
            "coordinator_address/num_processes/process_id (env: "
            "PYABC_TPU_COORDINATOR / PYABC_TPU_NUM_PROCESSES / "
            "PYABC_TPU_PROCESS_ID), or none of them for torch.distributed's "
            "env:// rendezvous (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    return dict(explicit, backend=backend)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str = "gloo",
               timeout: float | None = None) -> None:
    """``torch.distributed.init_process_group`` with env-var defaults.

    ``coordinator_address`` is the rendezvous URL (``tcp://host:port`` or
    ``file:///path``; a bare ``host:port`` is taken as tcp). Env fallbacks:
    ``PYABC_TPU_COORDINATOR``, ``PYABC_TPU_NUM_PROCESSES``,
    ``PYABC_TPU_PROCESS_ID``; with none of the three, torch's ``env://``
    rendezvous. A partial configuration raises
    :class:`DistributedConfigError`. ``timeout`` (seconds) bounds every
    collective, so a rank that died fails the others instead of hanging
    them.

    Idempotent: a second call with the same resolved config is a no-op; a
    second call with another config raises
    :class:`DistributedConfigError`."""
    global _INIT_CONFIG
    config = _resolve_init_config(coordinator_address, num_processes,
                                  process_id, backend=backend)
    if _INIT_CONFIG is not None:
        if config == _INIT_CONFIG:
            return
        raise DistributedConfigError(
            "torch.distributed is already initialized with a different "
            f"config: first {_INIT_CONFIG!r}, now {config!r} — restart the "
            "process to change the mesh")
    addr = config["coordinator_address"]
    if addr is not None and "://" not in addr:
        addr = f"tcp://{addr}"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if addr is None:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, init_method=addr,
                                world_size=int(config["num_processes"]),
                                rank=int(config["process_id"]), **kw)
    _INIT_CONFIG = config


def global_mesh(device_type: str = "cuda", axis_name: str = "particles"):
    """A one-dimensional ``DeviceMesh`` over every process of the group,
    one device a process, in rank order. ``device_type`` is the device the
    run's tensors live on: ``"cuda"`` (the default), or ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def _rank(mesh=None) -> int:
    if mesh is not None:
        return int(mesh.get_local_rank())
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary(mesh=None) -> bool:
    """Whether this process is the primary: rank 0 of ``mesh``, or of the
    process group without one (a single process is its own primary)."""
    return _rank(mesh) == 0


def process_count(mesh=None) -> int:
    """The processes of ``mesh``, or of the process group (1 if
    single-process)."""
    if mesh is not None:
        return int(mesh.size())
    return dist.get_world_size() if dist.is_initialized() else 1


def primary_db(db: str, mesh=None) -> str:
    """The real db url on the primary, a throwaway in-memory store on the
    others (the History is written identically everywhere; one copy is
    enough and sqlite files must not be written by several processes).
    ``ABCSMC.new`` on a mesh applies this rule itself, so an ABCSMC user
    need not call it; it serves storage a caller opens itself."""
    return db if is_primary(mesh) else "sqlite://"


def barrier(mesh=None) -> None:
    """An explicit sync point of the processes of ``mesh`` (or of the
    group); rarely needed, every generation's gather already
    synchronizes."""
    if mesh is not None:
        dist.barrier(group=mesh.get_group())
    elif dist.is_initialized():
        dist.barrier()


__all__ = ["DistributedConfigError", "barrier", "global_mesh", "initialize",
           "is_primary", "primary_db", "process_count"]
