"""The sharded solver's collectives, in one place, over torch.distributed
(mgcfd_tpu's shard_map collectives: all_gather, psum_scatter, psum,
pmin).

The backend follows the device and is chosen by name when the process
group is made (init_process_group), never by catching an error:
  - NCCL when each rank has a card of its own;
  - gloo when the ranks run on the CPU (the tests);
  - gloo, asked for with share_card=True, when several ranks share one
    card: NCCL refuses two ranks on one device. This exists only to check
    the port on a one-card machine; Comm then copies every operand
    through host memory, since gloo's collectives take CPU tensors. A
    gloo group on a card that was not made so is refused.
Each rank owns one shard, shard p = rank p. bfloat16 travels as its
16-bit patterns in gathers and is summed in float32 (rounded once) in
reductions, so that both backends give the same bits.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

TIMEOUT_S = 600
# torch 2.13 renamed the tensor collectives (the old names warn); the
# card's torch may predate the new ones
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
# the default group that init_process_group made with share_card=True
# (None otherwise): the one gloo group whose ranks may sit on a card
_shared_card_group = None


def backend_for(device: torch.device, share_card: bool = False) -> str:
    """'nccl' for a card of the rank's own, else 'gloo'."""
    if device.type == "cuda":
        return "gloo" if share_card else "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def rank_device(device_type: str, rank: int,
                share_card: bool = False) -> torch.device:
    """Rank `rank`'s device: card `rank` under NCCL, card 0 when the ranks
    share it, else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", 0 if share_card else rank)
    return torch.device(device_type)


def init_process_group(rank: int, world_size: int, init_method: str,
                       device: torch.device, share_card: bool = False,
                       timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group with the backend that `device`
    (and share_card) names. init_method: 'file://PATH' (a FileStore, as
    the tests use) or 'tcp://localhost:PORT'."""
    global _shared_card_group
    if share_card and device.type != "cuda":
        raise ValueError(f"share_card is for ranks on a card, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device, share_card), init_method=init_method,
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _shared_card_group = dist.group.WORLD if share_card else None


class Comm:
    """The collectives of one rank on `device` over the default process
    group: all_gather, reduce_scatter and all_reduce (SUM, MIN)."""

    def __init__(self, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError(
                "the sharded solver needs a process group: call "
                "parallel.comm.init_process_group in every rank (or start "
                "the ranks with parallel.launch / torchrun)")
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        if self.backend == "nccl":
            if device.type != "cuda":
                raise ValueError("NCCL ranks run on cards; device "
                                 f"{device}")
            if self.size > torch.cuda.device_count():
                raise RuntimeError(
                    f"{self.size} NCCL ranks but {torch.cuda.device_count()} "
                    "card(s): NCCL takes one rank a card (ranks that share "
                    "a card run under gloo, share_card=True)")
        elif self.backend != "gloo":
            raise ValueError(f"unsupported backend {self.backend!r}")
        elif device.type == "cuda" and \
                _shared_card_group is not dist.group.WORLD:
            raise ValueError(
                f"a gloo group with its ranks on {device}: ranks on cards of "
                "their own run under NCCL; ranks that share a card ask for "
                "gloo with init_process_group(..., share_card=True)")
        # gloo takes CPU tensors: a card's operands go through the host
        self.via_host = self.backend == "gloo" and device.type == "cuda"

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture these collectives: NCCL's run
        on the card's streams; gloo's on the host."""
        return self.backend == "nccl"

    def _in(self, t: torch.Tensor, reduce: bool) -> torch.Tensor:
        if t.dtype == torch.bfloat16:
            t = t.float() if reduce else t.view(torch.float16)
        return (t.cpu() if self.via_host else t).contiguous()

    def _out(self, t: torch.Tensor, dtype) -> torch.Tensor:
        if self.via_host:
            t = t.to(self.device)
        if dtype == torch.bfloat16:
            t = t.to(dtype) if t.dtype == torch.float32 else t.view(dtype)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(...) on each rank -> (P, ...), rank p's at [p]."""
        src = self._in(t, reduce=False)
        # both backends concatenate along dim 0: gather flat, then view
        out = torch.empty(self.size * src.numel(), dtype=src.dtype,
                          device=src.device)
        _ALL_GATHER(out, src.reshape(-1))
        return self._out(out.view((self.size,) + tuple(src.shape)), t.dtype)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """(P, ...) on each rank -> (...): the sum over ranks of row p on
        rank p."""
        src = self._in(t, reduce=True)
        out = torch.empty(src.numel() // self.size, dtype=src.dtype,
                          device=src.device)
        _REDUCE_SCATTER(out, src.reshape(-1), op=dist.ReduceOp.SUM)
        return self._out(out.view(tuple(src.shape[1:])), t.dtype)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum ('sum') or min ('min') over ranks, as a new tensor."""
        buf = self._in(t, reduce=True).clone()
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "min": dist.ReduceOp.MIN}[op])
        return self._out(buf, t.dtype)
