"""Strip-ordered bitmask SpMM — the aggregation kernel of the main path.

``out = A^T h`` for a 0/1 adjacency tiled into (BD=256 dst x BS=2048 src)
bitmask tiles (format: ``spmm_block``), plus an ELLPACK straggler
(``spmm_fast``) for the edges of sparse tiles. The backward pass runs the
same kernel on the pre-built REVERSE layout (the reference aggregating
gradients on its ``bwd_graph``, ``AdaQP/model/ops.py:83-95``).

Host side: :func:`strip_layout` packs the dense tiles exactly as the JAX
package's ``strip_layout`` does (masks in destination-block-major order).
When a layout reaches a CUDA device, :func:`~.spmm_walk.strip_walk` derives
there what the CUDA kernel walks (a :class:`~.spmm_walk.StripWalk`, the
format the block and compact layouts decode into too): each strip's
schedule of source windows with each destination block's tile in them (the
idea of the JAX package's ``w_ord``/``sub``/``mask_idx`` for its window
ring, packed for the kernel's grid), and every tile row's set columns
decoded once into a list, so that no column slice of a pass re-reads the
masks.

Device side: :func:`strip_spmm` is the kernel wrapper. On a CUDA tensor it
launches the hand-written kernel (``csrc/spmm_strip.cu``), on a CPU tensor
it runs the plain PyTorch version :func:`_run_strip_torch`; there is no
fallback from one to the other. Numerics: both sum in f32 and round once to
``h.dtype``, so for bf16 ``h`` they differ only in summation order, and for
f32 ``h`` both are exact f32 sums. (The JAX package's accelerator kernel
also rounds f32 windows to bf16 before its matrix product; the port
follows the JAX package's portable twin there.)
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.backend import DeviceLike, resolve_device
from .spmm_block import ReverseSpmm, _dedup, block_pointers, run_tiles_torch, with_straggler
from .spmm_fast import EllDevice, EllLayout, ell_from_csr
from .spmm_walk import BD, BS, STRIP, WORDS, StripWalk, WalkedLayout, run_walk, strip_walk

MIN_EDGES = 192
STRIP_SCHEME = 1   # cache-format version


@dataclass
class StripLayout:
    """Host-side dense bitmask tiles + ELL straggler."""

    n: int
    n_pad: int        # out rows, STRIP multiple
    n_src_pad: int    # h rows, BS multiple
    masks: np.ndarray     # int16 [max(T, 1), BD, WORDS] (one zero row if T=0)
    tile_src: np.ndarray  # int32 [T] tile window start row (BS multiple)
    tile_dst: np.ndarray  # int32 [T] tile dst block, ascending
    straggler: Optional[EllLayout]

    def to_device(self, device: DeviceLike = None) -> "StripDevice":
        dev = resolve_device(device)
        return StripDevice(
            self.n, self.n_pad, self.n_src_pad,
            *(torch.as_tensor(a, device=dev) for a in (
                self.masks, self.tile_src, block_pointers(self.tile_dst, self.n_pad))),
            self.straggler.to_device(dev) if self.straggler else None,
        ).with_walk()


@dataclass
class StripDevice(WalkedLayout):
    """A strip layout's tensors on one device. Tiles ``blk_ptr[b]`` ..
    ``blk_ptr[b + 1]`` of ``masks``/``tile_src`` belong to destination
    block ``b``; rows of ``masks`` past ``blk_ptr[-1]`` are padding. The
    plain version reads the masks, the CUDA kernel ``walk``, which is built
    where a layout reaches a CUDA device."""

    n: int
    n_pad: int
    n_src_pad: int
    masks: torch.Tensor     # int16 [T', BD, WORDS], T' >= blk_ptr[-1]
    tile_src: torch.Tensor  # int32 [T'']
    blk_ptr: torch.Tensor   # int32 [n_pad // BD + 1]
    straggler: Optional[EllDevice]
    walk: Optional[StripWalk] = None  # what the CUDA kernel reads

    def build_walk(self) -> StripWalk:
        return strip_walk(self.masks, self.tile_src, self.blk_ptr)

    def to(self, device: DeviceLike) -> "StripDevice":
        return StripDevice(
            self.n, self.n_pad, self.n_src_pad,
            *(x.to(device) for x in (self.masks, self.tile_src, self.blk_ptr)),
            self.straggler.to(device) if self.straggler else None,
            None if self.walk is None else self.walk.to(device),
        ).with_walk()


def strip_layout(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    min_edges: int = MIN_EDGES,
    cache_key: Optional[str] = None,
    dedup: bool = True,
    n_src: Optional[int] = None,
) -> StripLayout:
    """Build the dense-tile layout for edges src -> dst: ``n`` destination
    rows, ``n_src`` source rows (defaults to ``n``; halo groups are
    rectangular)."""
    from .spmm_fast import ell_cache_ok, ell_load_npz, ell_save_npz

    if cache_key and os.path.exists(cache_key + ".npz"):
        z = np.load(cache_key + ".npz")
        if (
            int(z.get("strip_scheme", 0)) == STRIP_SCHEME
            and ell_cache_ok(z)
            and int(z.get("min_edges", -1)) == min_edges
            and int(z["n"]) == n
        ):
            return StripLayout(
                int(z["n"]), int(z["n_pad"]), int(z["n_src_pad"]), z["masks"],
                z["tile_src"], z["tile_dst"], ell_load_npz(z),
            )

    if n_src is None:
        n_src = n
    if dedup:
        nn = max(n, n_src)
        src, dst = _dedup(src, dst, nn)
    elif len(src) and len(np.unique(src.astype(np.int64) * n + dst)) != len(src):
        raise ValueError(
            "strip layout requires a simple graph (duplicate edges found); "
            "deduplicate upstream or pass dedup=True"
        )
    n_pad = -(-n // STRIP) * STRIP
    n_src_pad = -(-n_src // BS) * BS

    tb = dst.astype(np.int64) // BD
    sb = src.astype(np.int64) // BS
    tile_key = tb * (n_src_pad // BS) + sb
    order = np.argsort(tile_key, kind="stable")
    tile_key_s = tile_key[order]
    src_s, dst_s = src[order], dst[order]
    uniq_tiles, tile_ptr = np.unique(tile_key_s, return_index=True)
    tile_ptr = np.append(tile_ptr, len(tile_key_s))
    counts = np.diff(tile_ptr)
    dense = counts >= min_edges

    straggler = None
    str_mask = np.zeros(len(src_s), bool)
    for ti in np.where(~dense)[0]:
        str_mask[tile_ptr[ti] : tile_ptr[ti + 1]] = True
    if str_mask.any():
        straggler = ell_from_csr(src_s[str_mask], dst_s[str_mask], n_pad)

    # pack dense tile masks in tile_key order: dst block major, window minor
    sel = np.where(dense)[0]
    t_sb = np.empty(len(sel), np.int64)
    t_tb = np.empty(len(sel), np.int64)
    masks_list = []
    for oi, ti in enumerate(sel):
        key = uniq_tiles[ti]
        b_dst = int(key // (n_src_pad // BS))
        b_src = int(key % (n_src_pad // BS))
        sl = slice(tile_ptr[ti], tile_ptr[ti + 1])
        i = (dst_s[sl] - b_dst * BD).astype(np.int64)
        j = (src_s[sl] - b_src * BS).astype(np.int64)
        m = np.zeros(BD * WORDS, np.uint16)
        np.bitwise_or.at(
            m, i * WORDS + j % WORDS, np.uint16(1) << (j // WORDS).astype(np.uint16)
        )
        masks_list.append(m.reshape(BD, WORDS))
        t_sb[oi] = b_src
        t_tb[oi] = b_dst
    if not masks_list:  # keep the mask array non-empty, like the reference's
        masks_list.append(np.zeros((BD, WORDS), np.uint16))
    masks = np.stack(masks_list).view(np.int16)
    tile_src = (t_sb * BS).astype(np.int32)
    tile_dst = t_tb.astype(np.int32)

    lay = StripLayout(n, n_pad, n_src_pad, masks, tile_src, tile_dst, straggler)
    if cache_key:
        os.makedirs(os.path.dirname(cache_key) or ".", exist_ok=True)
        save = dict(
            n=n, n_pad=n_pad, n_src_pad=n_src_pad, masks=masks,
            tile_src=tile_src, tile_dst=tile_dst,
            min_edges=min_edges, strip_scheme=STRIP_SCHEME,
        )
        ell_save_npz(save, straggler)
        np.savez(cache_key + ".npz", **save)
    return lay


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _run_strip_torch(layout: StripDevice, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: each dense tile's product with
    its source window, summed in f32 at its destination block
    (:func:`~adaqp_tpu_torch.ops.spmm_block.run_tiles_torch`); a layout with
    no tiles gives zeros."""
    if h.shape[0] != layout.n_src_pad:
        raise ValueError(f"h has {h.shape[0]} rows, layout wants {layout.n_src_pad}")
    blk_ptr = layout.blk_ptr.to(torch.int64)
    tile_dst = torch.repeat_interleave(
        torch.arange(blk_ptr.numel() - 1, device=blk_ptr.device), blk_ptr.diff()
    )
    return run_tiles_torch(layout.masks, layout.tile_src, tile_dst, layout.n_pad, h)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _run_strip_cuda(layout: StripDevice, h: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``h``'s device and current stream."""
    out = run_walk(layout, h, "strip")
    strip_spmm.launches += 1
    return out


def strip_spmm(layout: StripDevice, h: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: the dense-tile part of ``A^T h`` in ``h.dtype``.

    CUDA ``h``: the hand-written kernel (each launch adds one to
    ``strip_spmm.launches``). CPU ``h``: the plain PyTorch version."""
    if h.device.type == "cuda":
        return _run_strip_cuda(layout, h)
    if h.device.type == "cpu":
        return _run_strip_torch(layout, h)
    raise ValueError(f"no strip SpMM for device {h.device}")


strip_spmm.launches = 0


def run_strip(layout: StripDevice, h: torch.Tensor) -> torch.Tensor:
    """out = A^T h in ``h.dtype``: the dense tiles plus the ELL straggler,
    which is accumulated in f32 and added in ``h.dtype``."""
    return with_straggler(strip_spmm(layout, h), layout.straggler, h)


def spmm_strip(layout_fwd: StripDevice, h: torch.Tensor, reverse: StripDevice) -> torch.Tensor:
    """A^T h with strip bitmask tiles; the backward runs the reverse layout
    through the same kernel (argument order of the JAX package's
    ``spmm_strip``)."""
    return ReverseSpmm.apply(h, run_strip, layout_fwd, reverse)
