"""Data parallelism on ``torch.distributed``: the process group, the
collectives the models reduce through, and the rank launcher.

Counterpart of the data-parallel half of ``adversarial_learning_on_
pointclouds_tpu/parallel/mesh.py`` (``make_mesh``, ``make_multihost_mesh``,
``shard_batch``, ``replicate_tree``). The JAX package's partitioner turns
every batch reduction into a global one by itself; the port has no
partitioner, so every place that reduces over the batch (or, under point
sharding, over the points) calls this module:

* ``all_reduce_sum`` (backward: an all-reduce sum), ``all_reduce_max_points``
  (the max over the points of every rank; backward: the cotangent summed
  over the ranks, then given to the local points equal to the global max,
  split among ties as ``amax`` splits it) and ``gather_rows`` (the global
  batch on every rank; backward: an all-reduce sum, then the rank's own
  rows) are autograd functions of the port's own, built on ``all_reduce``
  alone: gloo runs only ``all_reduce`` and ``broadcast`` on CUDA tensors,
  so a gather is the sum of zero-padded buffers;
* ``spans`` and ``count`` say whether a reduction crosses the ranks and
  how many values it covers: every per-point reduction does at world
  size W > 1, a reduction over the rows only under data parallelism (a
  point-sharded step holds its ``[B, C]`` rows replicated);
* ``all_reduce_grads`` sums a network's gradients and the step's metrics
  in one flat bucket, ``broadcast_module`` copies rank 0's parameters and
  buffers to every rank (``replicate_tree``), ``shard_rows`` takes a
  rank's rows of a batch (``shard_batch``).

At world size 1 (no group) every collective is the identity and calls
nothing, so the single-device path runs bit for bit as before. The group
is flat: rank ``host * ranks_per_host + local`` is ``make_multihost_
mesh``'s host-major layout, and the topology below it is NCCL's (or
gloo's). Transport: NCCL where each rank has a card of its own, gloo
otherwise (the CPU, or several ranks sharing one card).

``spawn(fn, world_size, devices, backend)`` runs ``fn`` in one process a
rank and returns every rank's result; each rank imports torch, numpy and
this package only.
"""

from __future__ import annotations

import contextlib
import importlib
import multiprocessing
import queue
import socket
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as tdist

_state = threading.local()
# Collective name -> [calls, bytes], over every rank-local call since the
# last ``reset_counts`` (``chip_smoke.py`` prints a step's).
COUNTS: Dict[str, List[int]] = {}


# ---------------------------------------------------------------------------
# The group
# ---------------------------------------------------------------------------

def world_size() -> int:
    """The group's size; 1 when there is no group."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 when there is no group."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


def host_major_rank(host: int, local: int, ranks_per_host: int) -> int:
    """The rank of host ``host``'s ``local``-th rank: ``make_multihost_
    mesh``'s host-major layout, so one host's ranks hold contiguous rows
    of the batch."""
    if not 0 <= local < ranks_per_host:
        raise ValueError(f"local rank {local} outside 0..{ranks_per_host - 1}")
    return host * ranks_per_host + local


def default_backend(devices: Sequence) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def init(rank_: int, world_size_: int, init_method: str,
         backend: str = "gloo", device=None) -> None:
    """Join the group as ``rank_`` of ``world_size_`` at ``init_method``
    (``tcp://host:port``); a CUDA ``device`` becomes the current card."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    tdist.init_process_group(backend, init_method=init_method, rank=rank_,
                             world_size=world_size_)


def shutdown() -> None:
    """Leave the group, if there is one."""
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (nothing at world size 1)."""
    if world_size() > 1:
        tdist.barrier()


def free_port() -> int:
    """A free TCP port on localhost, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve_world(num_devices: int, device) -> int:
    """``--num_devices`` as a world size: 0 means every visible card (one
    rank on the CPU); a number above the visible cards raises on CUDA; on
    the CPU ``W`` means W gloo ranks."""
    if num_devices < 0:
        raise ValueError(f"num_devices {num_devices} is negative")
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if num_devices > visible:
            raise ValueError(f"num_devices={num_devices}, but {visible} "
                             "CUDA device(s) are visible")
        return num_devices or visible
    return max(num_devices, 1)


def rank_device(device) -> torch.device:
    """This rank's device: on CUDA the card the rank was given (the
    current one), else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and world_size() > 1:
        return torch.device("cuda", torch.cuda.current_device())
    return device


# ---------------------------------------------------------------------------
# What a reduction covers
# ---------------------------------------------------------------------------

def points_sharded() -> bool:
    """Whether the point axis is split across the ranks (inside
    ``point_sharding`` at world size above 1)."""
    return getattr(_state, "points", False) and world_size() > 1


@contextlib.contextmanager
def point_sharding():
    """Within the context every rank holds a slice of each cloud's points
    (``[B, N / W, C]``) and the whole batch: per-point reductions cross
    the ranks and ``[B, C]`` rows are replicated. Per thread."""
    prev = getattr(_state, "points", False)
    _state.points = True
    try:
        yield
    finally:
        _state.points = prev


def spans(per_point: bool) -> bool:
    """Whether a reduction over the batch rows, and with ``per_point`` the
    points too, crosses the ranks: every such reduction under data
    parallelism, only the per-point ones under point sharding."""
    if world_size() == 1:
        return False
    return per_point or not points_sharded()


def count(m: int, per_point: bool) -> int:
    """The global number of values behind a reduction of ``m`` local ones
    (equal shards)."""
    return m * world_size() if spans(per_point) else m


def global_points(n: int) -> int:
    """The points of a cloud of which a rank holds ``n``: ``n W`` under
    point sharding, else ``n``."""
    return n * world_size() if points_sharded() else n


def mean_share(t: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global mean of ``t`` (``[B]`` per cloud,
    ``[B, N, ...]`` per point), so that the ranks' shares sum to it: the
    local sum over the global count where the reduction crosses the
    ranks, a replicated term's mean over W (it enters the sum once, not W
    times). ``t.mean()`` at world size 1."""
    w = world_size()
    if w == 1:
        return t.mean()
    per_point = t.dim() >= 2
    if spans(per_point):
        return t.sum() / count(t.numel(), per_point)
    return t.mean() / w


def draw_shape(shape: Sequence[int], per_point: bool = False) -> tuple:
    """The global shape of a random draw whose local shape is ``shape``
    (``[B, ...]``; ``per_point``: ``[B, N, ...]``), so that every rank
    draws what world size 1 draws and keeps its part (``own_draw``)."""
    shape = tuple(shape)
    w = world_size()
    if w == 1:
        return shape
    if points_sharded():
        return (shape[:1] + (shape[1] * w,) + shape[2:]) if per_point \
            else shape
    return (shape[0] * w,) + shape[1:]


def own_draw(t: torch.Tensor, per_point: bool = False) -> torch.Tensor:
    """This rank's part of a draw of ``draw_shape``: its rows under data
    parallelism, its points under point sharding."""
    w = world_size()
    if w == 1:
        return t
    if points_sharded():
        return shard_rows(t, dim=1) if per_point else t
    return shard_rows(t)


def shard_rows(t, dim: int = 0):
    """Rank r's block ``[r L, (r + 1) L)`` of axis ``dim`` (``L = n / W``)
    of a tensor or an array; raises when W does not divide the axis."""
    w, n = world_size(), t.shape[dim]
    if w == 1:
        return t
    if n % w:
        raise ValueError(f"an axis of {n} does not split over {w} ranks")
    size = n // w
    r = rank()
    if isinstance(t, torch.Tensor):
        return t.narrow(dim, r * size, size)
    index = [slice(None)] * t.ndim
    index[dim] = slice(r * size, (r + 1) * size)
    return t[tuple(index)]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, List[int]]:
    """``{name: [calls, bytes]}`` since the last ``reset_counts``."""
    return {k: list(v) for k, v in COUNTS.items()}


def _tally(name: str, t: torch.Tensor) -> None:
    entry = COUNTS.setdefault(name, [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, op: str = "sum",
                name: str = "stats") -> torch.Tensor:
    """In-place all-reduce of ``t`` (``op`` ``sum`` or ``max``), counted
    under ``name``; no autograd. Returns ``t``."""
    if world_size() == 1:
        return t
    _tally(name, t)
    tdist.all_reduce(t, tdist.ReduceOp.SUM if op == "sum"
                     else tdist.ReduceOp.MAX)
    return t


def broadcast_(t: torch.Tensor, src: int = 0,
               name: str = "broadcast") -> torch.Tensor:
    """In-place broadcast of ``t`` from rank ``src``. Returns ``t``."""
    if world_size() == 1:
        return t
    _tally(name, t)
    tdist.broadcast(t, src)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return all_reduce_(x.detach().clone().contiguous(), "sum", name)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone().contiguous(), "sum", ctx.name), None


def all_reduce_sum(x: torch.Tensor, name: str = "stats") -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; its backward is an
    all-reduce sum of the cotangent. The identity at world size 1."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x, name)


def reduce_sum(x: torch.Tensor, per_point: bool,
               name: str = "stats") -> torch.Tensor:
    """``all_reduce_sum`` where the reduction behind ``x`` crosses the
    ranks (``spans``), else ``x``."""
    return all_reduce_sum(x, name) if spans(per_point) else x


class _AllReduceMaxPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        mx = all_reduce_(x.detach().amax(dim=1).contiguous(), "max", "max")
        ctx.save_for_backward(x, mx)
        return mx

    @staticmethod
    def backward(ctx, g):
        x, mx = ctx.saved_tensors
        g = all_reduce_(g.clone().contiguous(), "sum", "max")
        hit = x == mx[:, None]
        ties = all_reduce_(hit.sum(1).to(g.dtype), "sum", "max")
        return torch.where(hit, (g / ties)[:, None], torch.zeros((), dtype=g.dtype,
                                                                 device=g.device))


def all_reduce_max_points(x: torch.Tensor) -> torch.Tensor:
    """``x [B, N_local, C]`` -> the max over the points of every rank,
    ``[B, C]``, on every rank. Backward: the cotangent summed over the
    ranks goes to the local points equal to the global max, split evenly
    among all ranks' ties, as ``amax`` splits it. ``x.amax(1)`` at world
    size 1."""
    if world_size() == 1:
        return x.amax(dim=1)
    return _AllReduceMaxPoints.apply(x)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks (no gradient)."""
    return all_reduce_(x.detach().clone().contiguous(), "max", "max")


def _gather_layout(x: torch.Tensor, groups: int):
    gb = x.shape[0]
    if gb % groups:
        raise ValueError(f"batch {gb} does not split into {groups} groups")
    return gb // groups, tuple(x.shape[1:])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        b, rest = _gather_layout(x, groups)
        w, r = world_size(), rank()
        ctx.groups, ctx.b, ctx.rest = groups, b, rest
        buf = x.new_zeros((groups, w, b) + rest)
        buf[:, r] = x.detach().reshape((groups, b) + rest)
        all_reduce_(buf, "sum", "gather")
        return buf.reshape((groups * w * b,) + rest)

    @staticmethod
    def backward(ctx, g):
        w = world_size()
        g = all_reduce_(g.contiguous().clone(), "sum", "gather")
        g = g.reshape((ctx.groups, w, ctx.b) + ctx.rest)[:, rank()]
        return g.reshape((ctx.groups * ctx.b,) + ctx.rest), None


def gather_rows(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """The global batch of ``x``'s rows on every rank: ``x [G b, ...]``,
    ``G = groups`` stacked streams of ``b`` local rows each, -> ``[G W b,
    ...]`` with each stream's blocks contiguous, ``[a_0 ... a_(W-1) | b_0
    ... b_(W-1)]``. Built as an all-reduce sum of a zero-padded buffer;
    backward: an all-reduce sum, then the rank's own rows. ``x`` itself
    at world size 1."""
    if world_size() == 1:
        return x
    return _GatherRows.apply(x, groups)


def own_rows(y: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """This rank's rows of a ``gather_rows``-laid-out ``y [G W b, ...]``:
    ``[G b, ...]`` (a view; autograd passes through). ``y`` at world size
    1."""
    w = world_size()
    if w == 1:
        return y
    b = y.shape[0] // (groups * w)
    rest = tuple(y.shape[1:])
    return y.reshape((groups, w, b) + rest)[:, rank()].reshape(
        (groups * b,) + rest)


def gather_axis(y: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's block of axis ``dim`` of ``y``, in rank order, on
    every rank (no gradient): a data-parallel eval's rows, a point-sharded
    output's points. ``y`` at world size 1."""
    w = world_size()
    if w == 1:
        return y
    y = y.detach().movedim(dim, 0)
    buf = y.new_zeros((w,) + tuple(y.shape))
    buf[rank()] = y
    all_reduce_(buf, "sum", "gather")
    return buf.reshape((w * y.shape[0],) + tuple(y.shape[1:])).movedim(0, dim)


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     metrics: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Optional[Dict[str, torch.Tensor]]:
    """Sum every ``.grad`` of ``params`` over the ranks in place, and the
    step's ``metrics`` (each rank's share) with them, in one flat bucket
    and one all-reduce; returns the summed metrics (the global ones).
    Runs between ``backward()`` and ``optimizer.step()``. Parameters
    without a gradient stay without one (the same on every rank). At
    world size 1 nothing is called and ``metrics`` come back as given."""
    if world_size() == 1:
        return metrics
    grads = [p.grad for p in params if p.grad is not None]
    metrics = metrics or {}
    parts = [g.reshape(-1) for g in grads]
    parts += [v.detach().reshape(-1) for v in metrics.values()]
    if not parts:
        return metrics
    flat = torch.cat(parts)
    all_reduce_(flat, "sum", "grads")
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n
    out = {}
    for k, v in metrics.items():
        out[k] = flat[off:off + v.numel()].reshape(v.shape).to(v.dtype)
        off += v.numel()
    return out


def _flat_bytes(tensors) -> torch.Tensor:
    """The tensors' bytes, concatenated (one collective for all of them)."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank, in place
    (``replicate_tree``), in one broadcast of their bytes."""
    if world_size() == 1:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    flat = broadcast_(_flat_bytes(tensors), src, "broadcast")
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel() * t.element_size()
            t.data.copy_(flat[off:off + n].clone().view(t.dtype).view_as(t))
            off += n


def same_on_every_rank(tensors: Iterable[torch.Tensor]) -> bool:
    """Whether every tensor is bit for bit rank 0's on every rank (a
    check for tests and the chip smoke: rank 0's bytes are broadcast and
    compared, and the verdict is the minimum over the ranks)."""
    if world_size() == 1:
        return True
    mine = _flat_bytes(tensors)
    ref = mine.clone()
    tdist.broadcast(ref, 0)
    ok = torch.tensor(int(torch.equal(mine, ref)), device=mine.device)
    tdist.all_reduce(ok, tdist.ReduceOp.MIN)
    return bool(ok.item())


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, r, w, init_method, backend, device, args, out_q):
    torch.set_num_threads(1)
    try:
        init(r, w, init_method, backend, device)
        result = fn(*args)
        out_q.put((r, True, result))
    except BaseException:          # reported to the launcher, which raises
        out_q.put((r, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn(fn: Callable, world_size_: int, devices: Optional[Sequence] = None,
          backend: Optional[str] = None, args: tuple = (),
          timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world_size_`` ranks, one spawned process
    each, joined in one group on localhost; returns the ranks' results
    in rank order (each must pickle: tensors on the CPU). ``devices``:
    one per rank (default all ``"cpu"``); ``backend`` by
    ``default_backend``. Each rank runs with one CPU thread. A rank that
    raises, or a group that outlives ``timeout`` seconds, stops every
    rank and raises here with the rank's traceback. ``fn`` must be a
    module-level function of an importable module (the port's workers
    are: a rank imports torch, numpy and this package, nothing else)."""
    devices = list(devices) if devices is not None else ["cpu"] * world_size_
    if len(devices) != world_size_:
        raise ValueError(f"{len(devices)} devices for {world_size_} ranks")
    backend = backend or default_backend(devices)
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size_, init_method, backend,
                               str(devices[r]), args, out_q))
             for r in range(world_size_)]
    for p in procs:
        p.start()
    results: Dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size_:
            left = deadline - time.monotonic()
            try:
                r, ok, val = out_q.get(timeout=max(min(left, 5.0), 0.01))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {procs.index(dead[0])} exited with code "
                        f"{dead[0].exitcode} before it reported")
                if left <= 0:
                    raise TimeoutError(f"{world_size_} ranks did not finish "
                                       f"within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{val}")
            results[r] = val
    finally:
        for p in procs:
            p.join(timeout=30.0 if len(results) == world_size_ else 0.5)
            if p.is_alive():
                p.terminate()
                p.join()
    return [results[r] for r in range(world_size_)]


def _cli_rank(module: str, argv: list) -> dict:
    result = importlib.import_module(module).main(argv)
    return {k: v for k, v in result.items() if k != "state"}


def cli_ranks(module: str, argv: Optional[Sequence[str]], num_devices: int,
              device) -> Optional[list]:
    """For a trainer CLI, ``module`` with ``main(argv)``: where
    ``num_devices`` resolves to W > 1 ranks and this process is in no
    group, run ``main(argv)`` on W spawned ranks (``cuda:0 .. W-1`` under
    NCCL, or W CPU ranks under gloo) and return their results (without
    the train state); else None, and the caller runs the trainer
    itself."""
    w = resolve_world(num_devices, device)
    if w == 1 or world_size() > 1:
        return None
    devices = ([f"cuda:{r}" for r in range(w)]
               if torch.device(device).type == "cuda" else ["cpu"] * w)
    argv = list(argv) if argv is not None else sys.argv[1:]
    return spawn(_cli_rank, w, devices, args=(module, argv))
