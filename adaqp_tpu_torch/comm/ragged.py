"""Ragged all-to-all: exact per-pair wire sizes for the boundary exchange.

The reference sends exactly the packed bytes each pair needs over gloo p2p
(``AdaQP/communicator/comm.py:193-222``). ``all_to_all_single`` with
per-pair split sizes does the same in one collective: each rank's flat
int32 word buffer is cut into ``send_splits[r]`` words for rank ``r``, and
the receiver's buffer holds ``recv_splits[s]`` words from each ``s`` back
to back. Gloo and NCCL both carry uneven splits, so the JAX package's dense
emulation for its CPU meshes has no counterpart here. Split sizes are host
``int`` lists, built once per plan.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def ragged_all_to_all(
    sendbuf: torch.Tensor,
    send_splits: List[int],
    recv_splits: List[int],
    async_op: bool = False,
) -> Tuple[torch.Tensor, Optional[dist.Work]]:
    """One all-to-all of ``sendbuf`` (1-D, ``sum(send_splits)`` elements)
    into a fresh buffer of ``sum(recv_splits)`` elements on the same
    device. Returns ``(recvbuf, work)``; with ``async_op`` the caller must
    ``work.wait()`` before reading ``recvbuf`` (``work`` is None
    otherwise)."""
    if sendbuf.dim() != 1 or sendbuf.numel() != sum(send_splits):
        raise ValueError(
            f"send buffer of {tuple(sendbuf.shape)} does not match the splits "
            f"(sum {sum(send_splits)})"
        )
    recvbuf = torch.empty(sum(recv_splits), dtype=sendbuf.dtype, device=sendbuf.device)
    work = dist.all_to_all_single(
        recvbuf, sendbuf, output_split_sizes=list(recv_splits),
        input_split_sizes=list(send_splits), async_op=async_op,
    )
    return recvbuf, work
