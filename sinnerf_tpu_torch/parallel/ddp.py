"""Data parallelism over cards: one process per card, the gradients
all-reduced between ``backward`` and the optimizers' steps.

Counterpart of ``sinnerf_tpu/parallel/mesh.py``.  The JAX package shards the
batch over a device mesh and lets GSPMD insert the gradient ``psum`` into
its one jitted step (mesh.py:8-14); here the data parallelism is written
out, as the reference's pytorch-lightning DDP ran it: one process per card
(``launch``), NCCL between cards and gloo between CPU processes, the state
replicated (every rank builds it from the same seed or checkpoint), each
rank's rows of the batch (``shard_rows``, mesh.py:55 ``shard_batch``), one
all-reduce per optimizer (``gradient_hook``), and the ray axis of an image
render sharded in contiguous slabs (``shard_rays`` / ``gather_rays``,
mesh.py:67).  Every loss is a mean over equal-sized items, so the mean over
ranks of each rank's mean gradient is the global batch's gradient up to
rounding, and the all-reduce leaves the same bits on every rank.

A ``torchrun`` launch (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` set, one
process per card on each host) is joined instead of spawned: that covers
several hosts, as ``maybe_initialize_distributed`` (mesh.py:80) does for the
JAX package.
"""

from __future__ import annotations

import datetime
import os
import shutil
import socket
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 120  # a rank that dies frees the others from a collective after this long
BIND_ATTEMPTS = 3  # fresh ports tried when the rendezvous port was taken meanwhile
# metrics reduced otherwise than by their mean over ranks
MIN_METRICS = ("train/depth_min",)
MAX_METRICS = ("train/depth_max",)
PSNR_METRICS = ("train/psnr",)  # the global batch's PSNR is that of its mean squared error


def torchrun_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world, local rank) of a ``torchrun`` launch, else None."""
    names = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
    if not all(n in os.environ for n in names):
        return None
    return tuple(int(os.environ[n]) for n in names)


def world_for(num_gpus: int, device="cuda") -> int:
    """The number of ranks that ``--num_gpus`` asks for on ``device``.

    On ``cuda`` it raises when fewer than ``num_gpus`` cards are visible: the
    port runs on the cards it was asked for or not at all (the JAX trainer
    prints and carries on with one chip, ``sinnerf_tpu/train/loop.py:108-114``).
    On ``cpu``, ``num_gpus`` is the number of gloo processes.  Under
    ``torchrun`` it must equal ``WORLD_SIZE``."""
    from sinnerf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if num_gpus < 1:
        raise ValueError(f"--num_gpus {num_gpus}: need at least 1")
    env = torchrun_env()
    if env is not None:
        _, world, local = env
        if num_gpus != world:
            raise ValueError(f"--num_gpus {num_gpus} under torchrun with WORLD_SIZE={world}: pass --num_gpus {world}")
        if dev.type == "cuda" and torch.cuda.device_count() <= local:
            raise RuntimeError(f"LOCAL_RANK={local} but {torch.cuda.device_count()} cards are visible")
        return world
    if dev.type == "cuda" and torch.cuda.device_count() < num_gpus:
        raise RuntimeError(f"--num_gpus {num_gpus} asks for {num_gpus} cards, {torch.cuda.device_count()} are "
                           f"visible; the port does not fall back to fewer (pass --num_gpus "
                           f"{torch.cuda.device_count()}, or --device cpu for gloo processes)")
    return num_gpus


def rank_device(device_type: str) -> torch.device:
    """This process's device: its current card (``launch`` set it) or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(backend: str, rank: int, world: int, init_method: str) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _worker(i, fn, world, device_type, backend, init_method, outdir, threads, args) -> None:
    """Rank ``i`` of a spawned launch: its card, its group, ``fn``, its
    result written where the parent reads it."""
    if device_type == "cuda":
        torch.cuda.set_device(i % torch.cuda.device_count())
    else:
        torch.set_num_threads(threads)
    _init(backend, i, world, init_method)
    try:
        result = fn(i, world, *args)
        torch.save(result, os.path.join(outdir, f"rank{i}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable[..., Any], world: int, device_type: str, *args, backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks and return their
    results in rank order (each must pickle).

    Spawns one process per rank (``start_method="spawn"``: CUDA cannot
    fork).  Rank r runs on card ``r % device_count`` (the CLIs ask
    ``world_for`` first, so one card each) or the CPU, with a share of this
    process's threads; its group is NCCL on cards and gloo on the CPU
    (``backend`` overrides: gloo runs several ranks on one card), with a
    finite timeout.  If any rank raises, ``launch`` raises.  On ``cuda`` the
    kernels are built here first, so the ranks load them instead of each
    running ``nvcc`` on every source.  Under ``torchrun`` this process joins
    that group as its one rank, and the list holds its own result."""
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    env = torchrun_env()
    if env is not None:
        rank, world, local = env
        if device_type == "cuda":
            torch.cuda.set_device(local)
        _init(backend, rank, world, "env://")
        try:
            if device_type == "cuda":
                if local == 0:
                    from sinnerf_tpu_torch.ops import _build

                    _build.build()
                barrier()
            return [fn(rank, world, *args)]
        finally:
            dist.destroy_process_group()
    if device_type == "cuda":
        from sinnerf_tpu_torch.ops import _build

        _build.build()
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // world)
    for attempt in range(BIND_ATTEMPTS):
        outdir = tempfile.mkdtemp(prefix="ddp-")
        try:
            init_method = f"tcp://localhost:{_free_port()}"
            try:
                mp.start_processes(_worker, (fn, world, device_type, backend, init_method, outdir, threads, args),
                                   nprocs=world, join=True, start_method="spawn")
            except mp.ProcessRaisedException as e:
                # the port was free when picked and taken before rank 0 bound
                # it: try another; any other failure is the caller's
                text = str(e).lower()
                if attempt + 1 < BIND_ATTEMPTS and ("address already in use" in text or "eaddrinuse" in text):
                    continue
                raise
            return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False) for r in range(world)]
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
    raise AssertionError("unreachable")


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def _comm_device() -> torch.device:
    """Where the group's backend takes tensors: the current card for NCCL,
    the host for gloo."""
    return rank_device("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")


def all_reduce_mean_(tensors: Sequence[torch.Tensor], world: int) -> None:
    """Replace each tensor by its mean over the ranks, in place: one buffer,
    one all-reduce (SUM, then / ``world``: gloo has no AVG)."""
    if world == 1 or not tensors:
        return
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"all_reduce_mean_ takes tensors of one dtype, got {sorted({str(t.dtype) for t in tensors})}")
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).to(_comm_device())
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.div_(world)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset : offset + n].view_as(t))
        offset += n


def gradient_hook(world: int) -> Callable[[Sequence[torch.optim.Optimizer]], None]:
    """A ``train_step`` ``grad_hook``: each optimizer's gradients replaced by
    their mean over the ranks, one all-reduce per optimizer.  Every
    parameter must have a gradient on every rank."""
    def hook(optimizers: Sequence[torch.optim.Optimizer]) -> None:
        for opt in optimizers:
            params = [p for group in opt.param_groups for p in group["params"]]
            missing = [i for i, p in enumerate(params) if p.grad is None]
            if missing:
                raise RuntimeError(f"parameters {missing} have no gradient on this rank: nothing to all-reduce")
            all_reduce_mean_([p.grad for p in params], world)

    return hook


def reduce_metrics(metrics: Dict[str, torch.Tensor], world: int) -> Dict[str, torch.Tensor]:
    """The global batch's scalars from each rank's: means over ranks, but
    ``train/depth_min`` / ``train/depth_max`` (min / max) and ``train/psnr``
    (the PSNR of the mean squared error).  Two all-reduces; every rank gets
    the same values."""
    if world == 1:
        return metrics
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    mean_part = torch.stack([10.0 ** (-v / 10.0) if k in PSNR_METRICS else v for k, v in zip(keys, vals)])
    extreme = torch.stack([-v if k in MAX_METRICS else v for k, v in zip(keys, vals)])
    mean_part, extreme = mean_part.to(_comm_device()), extreme.to(_comm_device())
    dist.all_reduce(mean_part, op=dist.ReduceOp.SUM)
    dist.all_reduce(extreme, op=dist.ReduceOp.MIN)
    mean_part = mean_part / world
    out = {}
    for i, k in enumerate(keys):
        if k in MIN_METRICS:
            v = extreme[i]
        elif k in MAX_METRICS:
            v = -extreme[i]
        elif k in PSNR_METRICS:
            v = -10.0 * torch.log10(mean_part[i])
        else:
            v = mean_part[i]
        out[k] = v.to(metrics[k].device)
    return out


def all_gather_rows(t: torch.Tensor, world: int) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated on the
    leading axis in rank order, on every rank, on ``t``'s device and dtype."""
    if world == 1:
        return t
    x = t.detach().to(_comm_device())
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(device=t.device, dtype=t.dtype)


def barrier() -> None:
    """Wait for every rank (nothing to wait for outside a group); NCCL's on
    this rank's card."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# --------------------------------------------------------------------------
# sharding
# --------------------------------------------------------------------------


def shard_rows(batch: Dict[str, torch.Tensor], rank: int, world: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s contiguous slice of each leaf's leading axis
    (``shard_batch``, mesh.py:55); the leading axis must divide by
    ``world``."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over {world} ranks")
        b = v.shape[0] // world
        out[k] = v[rank * b : (rank + 1) * b]
    return out


def bundle_rows(per_item: Sequence[int], rank: int, world: int, items: int) -> torch.Tensor:
    """Rank ``rank``'s rows of a batch's concatenated rays: ``train_step``
    renders its bundles one after another, each flattened item by item
    (``per_item`` rays per item in each), so a rank's rays are its items'
    rows of every bundle.  ``items`` is the global batch size."""
    b = items // world
    rows, offset = [], 0
    for n in per_item:
        rows.append(torch.arange(offset + rank * b * n, offset + (rank + 1) * b * n))
        offset += items * n
    return torch.cat(rows)


def shard_draws(draws, rows):
    """A draw tuple (``RenderDraws``, ``Step2Draws``, ``DCallDraws``,
    ``DiffAugDraws``) with ``rows`` of each tensor's leading axis taken: a
    rank's share of the global batch's draws.  ``()`` draws, the ones JAX
    makes once for the global batch, stay as they are."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws if draws.dim() == 0 else draws[rows]
    return type(draws)(*(shard_draws(d, rows) for d in draws))


def shard_rays(rays: torch.Tensor, rank: int, world: int, tile: int) -> Tuple[torch.Tensor, int]:
    """(rank's slab, the ray count before padding): the (N, 8) rays padded
    to a multiple of ``tile * world`` with rays of 1.0, as JAX pads
    (``render_chunked_sharded``, renderer.py:461), and cut into ``world``
    contiguous slabs of whole tiles."""
    n = rays.shape[0]
    pad = (-n) % (tile * world)
    if pad:
        rays = torch.cat([rays, rays.new_ones((pad, rays.shape[1]))])
    per = rays.shape[0] // world
    return rays[rank * per : (rank + 1) * per], n


def gather_rays(outputs: Dict[str, torch.Tensor], n: int, world: int) -> Dict[str, torch.Tensor]:
    """Each output of every rank's slab gathered in rank order, the padding
    cut off: the whole image's outputs, on every rank."""
    return {k: all_gather_rows(v, world)[:n] for k, v in outputs.items()}
