"""The process group (port of ``cap2det_tpu/parallel/distributed.py``).

The JAX package runs one program over a 1-D device mesh and lets XLA
insert the gradient all-reduce. The port runs one process per card in a
``torch.distributed`` process group: each process feeds its own slice of
the global batch, and the training step averages the gradients across
the group before the update (``train/trainer.py``, ``parallel/mesh.py``).

Launch with torchrun, which sets ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``::

    torchrun --nproc_per_node=N -m cap2det_tpu_torch.cli.train_main ...

or with the JAX launcher's ``JAX_COORDINATOR_ADDRESS`` (host:port) /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, so scripts written for the
JAX package still launch. ``spawn`` starts the ranks of one machine from
Python (tests, ``entry.dryrun_multichip``).
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import time

import torch
import torch.distributed as dist

log = logging.getLogger("cap2det_torch.distributed")

# A collective that waits longer than this fails the rank instead of
# hanging it: a lost rank leaves the others waiting in the all-reduce.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def settings(coordinator_address=None, num_processes=None, process_id=None,
             device="cuda", environ=None, cuda_count=None):
    """The group this process would join, from the arguments and the
    launcher's environment (torchrun's variables first, then the JAX
    launcher's), or None when neither names a group.

    Returns a dict: init_method ("tcp://host:port"), world_size, rank,
    local_rank, backend and device. NCCL refuses two ranks on one card,
    so the backend is NCCL only when every rank of the machine has a card
    of its own; gloo on the CPU or when ranks share a card (gloo takes
    CUDA tensors through the host)."""
    env = os.environ if environ is None else environ
    if coordinator_address is None:
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            coordinator_address = "%s:%s" % (env["MASTER_ADDR"],
                                             env["MASTER_PORT"])
        else:
            coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        found = env.get("WORLD_SIZE") or env.get("JAX_NUM_PROCESSES")
        num_processes = int(found) if found else None
    if process_id is None:
        found = env.get("RANK") or env.get("JAX_PROCESS_ID")
        process_id = int(found) if found else None
    if coordinator_address is None and num_processes is None:
        return None
    if coordinator_address is None or num_processes is None:
        raise ValueError(
            "a process group needs an address and a world size: got %r, %r"
            % (coordinator_address, num_processes))
    rank = 0 if process_id is None else process_id
    if not 0 <= rank < num_processes:
        raise ValueError("rank %d outside a world of %d"
                         % (rank, num_processes))
    local_rank = int(env.get("LOCAL_RANK", rank))
    # Without torchrun's count, the ranks are taken to share one machine.
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))

    device = torch.device(device)
    if device.type == "cpu":
        backend = "gloo"
    else:
        if cuda_count is None:
            cuda_count = torch.cuda.device_count()
        if cuda_count < 1:
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to train "
                "on the CPU")
        backend = "nccl" if local_world <= cuda_count else "gloo"
        device = torch.device("cuda", local_rank % cuda_count)
    return {"init_method": "tcp://" + coordinator_address,
            "world_size": num_processes, "rank": rank,
            "local_rank": local_rank, "backend": backend, "device": device}


def maybe_initialize(coordinator_address=None, num_processes=None,
                     process_id=None, *, device="cuda",
                     timeout=DEFAULT_TIMEOUT):
    """Joins the process group when the arguments or the launcher's
    environment name one (``settings``); a no-op returning False when
    none does.

    Returns the rank's device: ``cuda:LOCAL_RANK`` (modulo the cards
    present) unless `device` is "cpu". Every collective of the group
    fails after `timeout` (a ``datetime.timedelta``) instead of hanging.
    """
    found = settings(coordinator_address, num_processes, process_id, device)
    if found is None:
        return False
    if found["device"].type == "cuda":
        torch.cuda.set_device(found["device"])
    dist.init_process_group(
        backend=found["backend"], init_method=found["init_method"],
        world_size=found["world_size"], rank=found["rank"], timeout=timeout)
    log.info("process group: rank %d of %d, %s on %s", found["rank"],
             found["world_size"], found["backend"], found["device"])
    return found["device"]


def shutdown():
    """Destroys the process group if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(index, fn, world, port, device, timeout, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(index),
                      LOCAL_RANK=str(index), LOCAL_WORLD_SIZE=str(world))
    rank_device = maybe_initialize(device=device, timeout=timeout)
    try:
        fn(rank_device, *args)
    finally:
        shutdown()


def spawn(fn, world, args=(), device="cuda", timeout=600.0):
    """Runs ``fn(rank_device, *args)`` in `world` new processes on this
    machine, each a rank of one process group on localhost.

    The processes are spawned, not forked, and are not daemons, so a
    rank can start a DataLoader worker. `fn` and `args` must pickle; `fn`
    lives in a module that a new interpreter can import. Raises if a rank
    fails, ending the others, or when the ranks are not all done within
    `timeout` seconds, killing them. Collectives time out with it too."""
    import torch.multiprocessing as mp

    group_timeout = datetime.timedelta(seconds=timeout)
    context = mp.start_processes(
        _rank_main, args=(fn, world, free_port(), device, group_timeout,
                          tuple(args)),
        nprocs=world, join=False, daemon=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError("%d ranks did not finish within %.0f s"
                                   % (world, timeout))
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
            process.join(10)
