"""Gather-only ELLPACK SpMM — the straggler path beside the bitmask tiles.

The graph is lowered host-side to degree-bucketed ELLPACK *segments*: each
dst row's (dst-sorted CSR) edge list is split into segments of at most
``WMAX`` sources, each segment placed in the bucket of the smallest listed
width >= its length. The forward pass is a gather + masked lane sum per
bucket, plus one mostly-unique scatter-add of segment sums into output
rows (segments-per-node ~= 1). The layout format is the JAX package's, so
the bucket arrays are the same on the same edges.

The device side is plain PyTorch: the reference computes it with XLA ops,
not with a kernel of its own (``_run_ell``).

Reference analog: DGL's ``update_all(copy_src, sum)`` SpMM
(``AdaQP/model/ops.py:17-32``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..common.backend import DeviceLike, resolve_device

WMAX = 512
ROW_CHUNK = 2048  # bucket rows are padded to this multiple

# Bucket widths with ~1.5x steps: every gathered lane costs the same whether
# masked or real, so these waste ~17% of lanes where powers of two waste ~33%.
_WIDTHS = np.array(
    [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512],
    np.int64,
)
ELL_SCHEME = 2  # cache-format version (bump when _WIDTHS changes)
# gathered elements per step of _run_ell: bounds its [rows, width, F] temporaries
_GATHER_ELEMS = 1 << 25


def _width_bucket(x: np.ndarray) -> np.ndarray:
    """Smallest bucket width >= x."""
    return _WIDTHS[np.searchsorted(_WIDTHS, np.maximum(x, 1))]


@dataclass
class EllLayout:
    """Host-side ELLPACK segments. ``buckets[i] = (width, rows, idx, lens)``:
    rows int32 [Nb] output row per segment; idx int32 [Nb, width] source
    rows (junk on padding lanes); lens int32 [Nb] valid lane count.
    ``row_chunk`` is baked in at build time (Nb is padded to it); padding
    segments target the drop row ``n``."""

    n: int
    buckets: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]
    row_chunk: int = ROW_CHUNK

    def to_device(self, device: DeviceLike = None) -> "EllDevice":
        dev = resolve_device(device)
        return EllDevice(
            self.n,
            tuple(
                (w, torch.as_tensor(rows, device=dev),
                 torch.as_tensor(idx, device=dev),
                 torch.as_tensor(lens, device=dev))
                for w, rows, idx, lens in self.buckets
            ),
            self.row_chunk,
        )


@dataclass
class EllDevice:
    """:class:`EllLayout` with int32 tensors on one device."""

    n: int
    buckets: Tuple[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor], ...]
    row_chunk: int = ROW_CHUNK

    def to(self, device: DeviceLike) -> "EllDevice":
        return EllDevice(
            self.n,
            tuple((w, r.to(device), i.to(device), l.to(device))
                  for w, r, i, l in self.buckets),
            self.row_chunk,
        )


def ell_cache_ok(z) -> bool:
    """True when a layout npz's embedded ELL straggler (if any) matches the
    current ELL_SCHEME (callers bump their own scheme keys separately)."""
    return not (int(z["has_straggler"]) and int(z.get("ell_scheme", 1)) != ELL_SCHEME)


def ell_save_npz(save: dict, straggler) -> None:
    """Serialize an optional EllLayout into a layout npz dict."""
    save["has_straggler"] = int(straggler is not None)
    save["ell_scheme"] = ELL_SCHEME
    if straggler is not None:
        save["ell_num_buckets"] = len(straggler.buckets)
        save["ell_row_chunk"] = straggler.row_chunk
        for i, (w, rows, idx, lens) in enumerate(straggler.buckets):
            save[f"ell_w{i}"] = w
            save[f"ell_rows{i}"] = rows
            save[f"ell_idx{i}"] = idx
            save[f"ell_lens{i}"] = lens


def ell_load_npz(z):
    """Inverse of ell_save_npz: optional EllLayout from a layout npz."""
    if not int(z["has_straggler"]):
        return None
    nbk = int(z["ell_num_buckets"])
    buckets = [
        (int(z[f"ell_w{i}"]), z[f"ell_rows{i}"], z[f"ell_idx{i}"],
         z[f"ell_lens{i}"])
        for i in range(nbk)
    ]
    return EllLayout(int(z["n_pad"]), buckets, int(z["ell_row_chunk"]))


def ell_from_csr(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    wmax: int = WMAX,
    row_chunk: int = ROW_CHUNK,
    cache_key: Optional[str] = None,
) -> EllLayout:
    """Build the ELLPACK-segment layout from an edge list (any order).

    ``cache_key``: path prefix; caches the built arrays as ``<key>.npz``.
    """
    if cache_key and os.path.exists(cache_key + ".npz"):
        z = np.load(cache_key + ".npz")
        if (
            int(z.get("row_chunk", ROW_CHUNK)) == row_chunk
            and int(z.get("ell_scheme", 1)) == ELL_SCHEME
        ):
            nb = int(z["num_buckets"])
            buckets = [
                (int(z[f"w{i}"]), z[f"rows{i}"], z[f"idx{i}"], z[f"lens{i}"])
                for i in range(nb)
            ]
            return EllLayout(n, buckets, row_chunk)

    order = np.argsort(dst, kind="stable")
    src_s = src[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    np.cumsum(indptr, out=indptr)
    deg = np.diff(indptr)

    nseg = -(-deg // wmax)  # zero-degree rows contribute no segments
    seg_node = np.repeat(np.arange(n, dtype=np.int64), nseg)
    within = (
        np.concatenate([np.arange(k) for k in nseg if k])
        if nseg.sum()
        else np.empty(0, np.int64)
    )
    seg_start = indptr[seg_node] + within * wmax
    seg_len = np.minimum(wmax, deg[seg_node] - within * wmax).astype(np.int64)
    assert (seg_len > 0).all()
    width = _width_bucket(seg_len)

    buckets = []
    e_total = len(src_s)
    for w in sorted(set(width.tolist())):
        m = width == w
        rows = seg_node[m].astype(np.int32)
        starts = seg_start[m]
        lens = seg_len[m].astype(np.int32)
        nb = len(rows)
        nb_pad = -(-nb // row_chunk) * row_chunk
        gather = starts[:, None] + np.arange(w)[None, :]
        np.clip(gather, 0, e_total - 1, out=gather)
        idx = src_s[gather].astype(np.int32)
        if nb_pad != nb:
            # padding segments scatter to the drop sentinel row `n`
            rows = np.concatenate([rows, np.full(nb_pad - nb, n, np.int32)])
            idx = np.concatenate([idx, np.zeros((nb_pad - nb, w), np.int32)])
            lens = np.concatenate([lens, np.ones(nb_pad - nb, np.int32)])
        buckets.append((int(w), rows, idx, lens))

    lay = EllLayout(n, buckets, row_chunk)
    if cache_key:
        os.makedirs(os.path.dirname(cache_key) or ".", exist_ok=True)
        save = {
            "num_buckets": len(buckets), "row_chunk": row_chunk,
            "ell_scheme": ELL_SCHEME,
        }
        for i, (w, rows, idx, lens) in enumerate(buckets):
            save[f"w{i}"] = w
            save[f"rows{i}"] = rows
            save[f"idx{i}"] = idx
            save[f"lens{i}"] = lens
        np.savez(cache_key + ".npz", **save)
    return lay


def _run_ell(ell: EllDevice, h: torch.Tensor, acc_dtype=None) -> torch.Tensor:
    """out[v] = sum over ELL lanes of h[idx] (masked) — gather-only SpMM.

    ``acc_dtype`` sets the accumulation/output dtype (default: ``h.dtype``);
    rows are always gathered in ``h.dtype`` — bf16 ``h`` with f32
    accumulation halves the gather's memory traffic without changing the
    math. Segment sums land with ``index_add_`` into ``n + 1`` rows whose
    last one, the padding segments' target, is dropped. On the card the
    scatter-add's order (and so the f32 rounding where a row has several
    segments) may differ from run to run."""
    f = h.shape[1]
    acc_dtype = h.dtype if acc_dtype is None else acc_dtype
    out = torch.zeros((ell.n + 1, f), dtype=acc_dtype, device=h.device)
    for w, rows, idx, lens in ell.buckets:
        nb = idx.shape[0]
        step = max(1, _GATHER_ELEMS // (w * f))
        lane = torch.arange(w, device=h.device)
        for s in range(0, nb, step):
            lc = lens[s : s + step]
            g = h[idx[s : s + step]]  # [b, w, F] in h.dtype
            valid = (lane[None, :] < lc[:, None])[..., None]
            sums = torch.where(valid, g, 0).to(acc_dtype).sum(dim=1)
            out.index_add_(0, rows[s : s + step], sums)
    return out[: ell.n]
