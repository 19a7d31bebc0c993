"""Helpers that several of the port's test files share (not collected as
tests): random edge lists, the small strip layouts the strip kernel's walk
must take, the tile kernel's walk interpreted in torch, and a launch of two
CPU ranks beside the caller's JAX training.
Imports only numpy and pytest at the top, so that the card's machine (no
JAX there) imports it with ``tests/test_torch_gpu.py``."""
import numpy as np
import pytest


def random_edges(rng, n, e, n_src=None):
    """``e`` edges into ``n`` rows from ``n_src`` (default ``n``) sources:
    half near the diagonal, half uniform."""
    ns = n if n_src is None else n_src
    src = rng.integers(0, ns, e).astype(np.int32)
    dst = np.where(
        rng.random(e) < 0.5,
        (src + rng.integers(-300, 300, e)) % n,
        rng.integers(0, n, e),
    ).astype(np.int32)
    return src, dst


def strip_cases(rng):
    """name -> (src, dst, n, n_src, min_edges): the layouts the strip
    kernel's walk must take (tests/test_torch_spmm_strip.py checks their
    walk arrays on the CPU, tests/test_torch_gpu.py the kernel on them)."""
    e0 = np.zeros(0, np.int32)
    rs, rd = random_edges(rng, 2100, 30000, 5000)
    fs, fd = random_edges(rng, 2048, 6000, 4096)
    blk = np.repeat(np.arange(8), 400)  # block b's edges all in window b
    return {
        "empty": (e0, e0, 2048, 4096, 1),
        "rectangular": (rs, rd, 2100, 5000, 8),
        "full row": (np.concatenate([np.arange(2048, dtype=np.int32), fs]),
                     np.concatenate([np.full(2048, 300, np.int32), fd]), 2048, 4096, 1),
        "single edge": (np.array([3000], np.int32), np.array([100], np.int32), 2048, 4096, 1),
        "disjoint windows": ((blk * 2048 + rng.integers(0, 2048, blk.size)).astype(np.int32),
                             (blk * 256 + rng.integers(0, 256, blk.size)).astype(np.int32),
                             2048, 8 * 2048, 1),
    }


def interpret_walk(walk, h, n_pad):
    """The tile kernel's order of work in torch, in f32 (``walk`` a
    ``StripWalk`` on the CPU, ``h`` [n_src_pad, F]): each strip's windows in
    turn, each block's walk tile as groups of 16 rows in batches of columns,
    the padding column reading a zero row; the first ``n_pad`` rows."""
    import torch

    from adaqp_tpu_torch.ops.spmm_walk import BATCH, BD, BS, GROUP, SB, STRIP

    f = h.shape[1]
    n_strips = walk.strip_ptr.numel() - 1
    out = torch.zeros(n_strips * STRIP, f)
    cols = walk.cols.view(-1, GROUP, BATCH).long()
    groups = BD // GROUP
    for s in range(n_strips):
        for k in range(int(walk.strip_ptr[s]), int(walk.strip_ptr[s + 1])):
            start = int(walk.step_win[k])
            window = torch.cat([h[start:start + BS].float(), torch.zeros(1, f)])
            for b, tile in enumerate(walk.step_tile[k].tolist()):
                if tile < 0:
                    continue
                for i in range(groups):
                    g = tile * groups + i
                    batch = cols[walk.grp_ptr[g]:walk.grp_ptr[g + 1]]  # [nb, GROUP, BATCH]
                    row = (s * SB + b) * BD + i * GROUP
                    out[row:row + GROUP] += window[batch].sum((0, 2))
    return out[:n_pad]


def walk_row_lists(walk, n_tiles):
    """Each walk tile row's column list, read back from the kernel's groups
    (numpy arrays, tile-major), and whether every row's padding comes after
    its columns."""
    from adaqp_tpu_torch.ops.spmm_walk import BATCH, BD, BS, GROUP

    cols = walk.cols.numpy().reshape(-1, GROUP, BATCH)
    lists, tail_padded = [], True
    for g in range(n_tiles * BD // GROUP):
        batches = cols[walk.grp_ptr[g]:walk.grp_ptr[g + 1]]
        for p in range(GROUP):
            row = batches[:, p, :].reshape(-1)[:int(walk.grp_len[g])]
            real = row[row != BS]
            tail_padded &= bool((row[len(real):] == BS).all())
            lists.append(real)
    return lists, tail_padded


def walk_schedule(walk, n_pad):
    """Check a walk's schedule (every walk tile once; within a strip each
    window once, ascending, with a tile in it) and give each tile's
    (destination block, window start row)."""
    from adaqp_tpu_torch.ops.spmm_walk import SB, STRIP

    strip_ptr, win, tiles = (x.numpy() for x in (walk.strip_ptr, walk.step_win, walk.step_tile))
    assert strip_ptr.shape == (-(-n_pad // STRIP) + 1,) and strip_ptr[-1] == len(win)
    assert tiles.shape == (len(win), SB)
    n_tiles = walk.grp_len.numel() * 16 // 256
    np.testing.assert_array_equal(np.sort(tiles[tiles >= 0]), np.arange(n_tiles))
    where = {}
    for s in range(len(strip_ptr) - 1):
        assert (np.diff(win[strip_ptr[s]:strip_ptr[s + 1]]) > 0).all()
        for k in range(strip_ptr[s], strip_ptr[s + 1]):
            assert (tiles[k] >= 0).any()
            for b in np.flatnonzero(tiles[k] >= 0):
                where[int(tiles[k, b])] = (s * SB + int(b), int(win[k]))
    return where


def merged_targets(lay):
    """How many (strip, window, destination block) targets of a host
    compact layout take subtiles from more than one item (each is one walk
    tile on the card): the subtiles counted over all items, less the
    targets."""
    grp = lay.kind == 1
    used = ((lay.masks.view(np.uint16)[grp][..., None] >> (2 * np.arange(8))) & 3).any((1, 2))
    keys = [(st, w, d) for st, w, doff, u in zip(lay.strip_id[grp], lay.src_start[grp],
                                                 lay.dst_off[grp], used)
            for d in set(doff[u].tolist())]
    return len(keys) - len(set(keys))


def spawn_beside(worker, args, tmp):
    """Start the two CPU ranks in a thread (one torch thread a rank) and
    return a function that joins them and gives their results, so that the
    caller's JAX training overlaps theirs."""
    import threading

    from adaqp_tpu_torch.comm.distributed import spawn

    out = {}

    def launch():
        try:
            out["res"] = spawn(worker, 2, "cpu", args=args, workdir=f"{tmp}/launch")
        except BaseException as exc:  # re-raised by join
            out["exc"] = exc

    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")  # one thread a rank beside other test workers
    thread = threading.Thread(target=launch)
    thread.start()

    def join():
        thread.join()
        mp.undo()
        if "exc" in out:
            raise out["exc"]
        return out["res"]

    return join


def random_wire(rng, k, f_true, bits_set, has_params, out_len, n_src, forward=True,
                skip=((0, 2),), unused=(), lanes=(5, 40)):
    """A random one-direction wire of the port's lowering (``comm/wire.py``)
    over ``k`` ranks: every channel but those in ``skip`` carries
    ``lanes`` lanes of random widths from ``bits_set`` less ``unused``
    (whose buckets stay empty), source rows drawn from ``n_src`` with row 0
    sent to every peer; forward wires give each receiver unique
    destinations below ``out_len``, backward ones repeat them."""
    from adaqp_tpu_torch.comm.wire import _build_dir

    used = [b for b in bits_set if b not in unused]
    channels = {}
    dests = {wr: rng.permutation(out_len) for wr in range(k)}
    taken = {wr: 0 for wr in range(k)}
    for ws in range(k):
        for wr in range(k):
            if ws == wr or (ws, wr) in skip:
                continue
            n = int(rng.integers(*lanes))
            gi = rng.integers(0, n_src, n)
            gi[0] = 0  # a source row sent to every peer
            if forward:
                si = dests[wr][taken[wr]:taken[wr] + n]
                taken[wr] += n
            else:
                si = rng.integers(0, out_len, n)
            channels[(ws, wr)] = (rng.choice(used, n), gi, si)
    return _build_dir(channels, k, f_true, bits_set, has_params)


def received(bufs, wires, rank):
    """Rank ``rank``'s receive buffer: each sender's slice to it, senders
    ascending (what the ragged all-to-all delivers)."""
    import torch

    parts = []
    for ws, (buf, w) in enumerate(zip(bufs, wires)):
        o = sum(w.send_splits[:rank])
        parts.append(buf[o:o + w.send_splits[rank]])
    return torch.cat(parts)


def pack_by_buckets(w, src, key, f_true, trace=False):
    """The send side as the exchange composed it before one kernel launch
    served a direction: per bucket a row gather, the plain quantize-and-pack
    and ``param_words``, then a ``torch.cat`` of each peer's word and
    parameter slices (peers ascending; per peer the buckets' words, then
    their parameter words)."""
    import torch

    from adaqp_tpu_torch.comm.exchange import variance_proxy
    from adaqp_tpu_torch.ops.quant import param_words, to_width
    from adaqp_tpu_torch.ops.quant_cuda import _quant_pack_torch, stream_key

    nb = len(w.bits)
    words, pwords, traces = [None] * nb, [None] * nb, []
    for bi, b in enumerate(w.bits):
        if w.q_rows[bi].numel() == 0:
            continue
        rows = src[w.q_rows[bi]]
        if trace:
            traces.append(variance_proxy(rows.float(), f_true))
        if b == 32:
            words[bi] = to_width(rows.float(), w.fw[bi]).contiguous().view(torch.int32)
            pwords[bi] = torch.zeros(rows.shape[0], dtype=torch.int32, device=src.device)
        else:
            wd, scale, rmin = _quant_pack_torch(rows, b, f_true, w.fw[bi], stream_key(key, bi))
            words[bi], pwords[bi] = wd, param_words(scale, rmin)
    pieces, start = [], [0] * nb
    for j in range(len(w.send_cnt[0]) if nb else 0):
        cnt = [w.send_cnt[bi][j] for bi in range(nb)]
        for bi in range(nb):
            if cnt[bi]:
                pieces.append(words[bi][start[bi]:start[bi] + cnt[bi]].reshape(-1))
        if w.has_params:
            for bi in range(nb):
                if cnt[bi]:
                    pieces.append(pwords[bi][start[bi]:start[bi] + cnt[bi]])
        for bi in range(nb):
            start[bi] += cnt[bi]
    buf = torch.cat(pieces) if pieces else torch.empty(0, dtype=torch.int32, device=src.device)
    return buf, (torch.cat(traces) if traces else None)


def unpack_by_buckets(w, recvbuf, scatter_add, f_true, f_pad):
    """The receive side as the exchange composed it before: each bucket's
    received word blocks concatenated, dequantized into one row buffer
    (buckets in order), then the forward's gather ``rows[d_inv]`` or the
    backward's ``index_add_`` over the concatenated destinations."""
    import torch

    from adaqp_tpu_torch.ops.quant import dequantize_words, split_param_words

    nb = len(w.bits)
    blocks, pblocks = [[] for _ in range(nb)], [[] for _ in range(nb)]
    o = 0
    for j in range(len(w.recv_cnt[0]) if nb else 0):
        cnt = [w.recv_cnt[bi][j] for bi in range(nb)]
        for bi in range(nb):
            if cnt[bi]:
                n = cnt[bi] * w.wpr[bi]
                blocks[bi].append(recvbuf[o:o + n].view(cnt[bi], w.wpr[bi]))
                o += n
        if w.has_params:
            for bi in range(nb):
                if cnt[bi]:
                    pblocks[bi].append(recvbuf[o:o + cnt[bi]])
                    o += cnt[bi]
    r_tot = [sum(c) for c in w.recv_cnt]
    s_tot = sum(r_tot)
    rows = torch.empty((s_tot + (0 if scatter_add else 1), f_pad), dtype=torch.float32,
                       device=recvbuf.device)
    off = 0
    for bi, b in enumerate(w.bits):
        if not r_tot[bi]:
            continue
        part = rows[off:off + r_tot[bi]]
        words = torch.cat(blocks[bi])
        if b == 32:
            part[:, :w.fw[bi]] = words.view(torch.float32)
            part[:, w.fw[bi]:] = 0.0
        else:
            scale, rmin = split_param_words(torch.cat(pblocks[bi]))
            part.copy_(dequantize_words(words, scale, rmin, b, f_true, w.fw[bi], f_pad))
        off += r_tot[bi]
    if not scatter_add:
        rows[s_tot] = 0.0
        return rows[w.d_inv]
    out = torch.zeros((w.out_len, f_pad), dtype=torch.float32, device=recvbuf.device)
    if s_tot:
        out.index_add_(0, torch.cat(w.d_rows), rows)
    return out


def random_plan(rng, k, n_rows, lanes=(3, 12), skip=((0, 1),), spare=3):
    """A random boundary plan (the port's ``ExchangePlan``) over ``k``
    ranks of ``n_rows`` local rows: every channel but those in ``skip``
    carries ``lanes`` lanes of random rows, row 0 sent to every peer; each
    receiver's halo slots follow its senders in rank order, ``spare`` more
    slots receive nothing."""
    from adaqp_tpu_torch.graph.layout import ExchangePlan

    counts = np.zeros((k, k), np.int64)
    for s in range(k):
        for r in range(k):
            if s != r and (s, r) not in skip:
                counts[s, r] = rng.integers(*lanes)
    s_pad = max(int(counts.max()), 1)
    num_remote = counts.sum(0)
    r_pad = int(num_remote.max()) + spare
    send_idx = np.zeros((k, k, s_pad), np.int32)
    recv_slot = np.full((k, k, s_pad), r_pad, np.int32)
    for r in range(k):
        off = 0
        for s in range(k):
            c = int(counts[s, r])
            if s == r or not c:
                continue
            send_idx[s, r, :c] = rng.integers(0, n_rows, c)
            send_idx[s, r, 0] = 0  # a row sent to every peer
            recv_slot[r, s, :c] = off + np.arange(c)
            off += c
    zeros = np.zeros((k, k, s_pad), np.float32)
    return ExchangePlan(send_idx, recv_slot, counts, num_remote, zeros, zeros,
                        np.full((k, r_pad), -1, np.int64), s_pad, r_pad)


def rank_buckets(lowered, rank, device=None):
    """One layer's ``buckets_from_assignment`` output -> rank ``rank``'s
    ``(bits, quads)`` of int64 ``[K, cap]`` tensors."""
    import torch

    bits, arrays = lowered
    return bits, tuple(tuple(torch.as_tensor(a[rank]).long().to(device) for a in quad)
                       for quad in arrays)


def received_frames(bufs, frames, rank):
    """Rank ``rank``'s receive buffer of the padded wire: per bucket, chunk
    ``rank`` of each sender's slice, senders ascending (what each bucket's
    all-to-all delivers)."""
    import torch

    k = len(bufs)
    parts = []
    for i in range(len(frames[rank].bits)):
        for buf, fr in zip(bufs, frames):
            parts.append(fr.views(buf)[i].reshape(k, -1)[rank])
    return torch.cat(parts) if parts else bufs[rank][:0]


def frames_by_buckets(x, buckets, keys, f_true, backward=False, trace=None, quant_rows=None):
    """The send side as the padded exchange composed it before one kernel
    launch served a direction: per bucket ``i`` the lane gather (the
    backward's over the rows and a zero row for the sentinel slots; with
    ``trace``, an f32 ``[rows + 1]`` tensor, each gathered row's variance
    proxy into its slot), ``quant_rows`` (default the plain version) with
    the key ``keys[i]``, ``to_width``, ``pack_rows``, the bf16 pair and the
    frame's concatenation: one uint8 ``[K, cap, bytes + 4]`` tensor a
    bucket."""
    import torch

    from adaqp_tpu_torch.comm.exchange import variance_proxy
    from adaqp_tpu_torch.ops.quant import pack_rows, pad_features, to_width
    from adaqp_tpu_torch.ops.quant_cuda import _quant_rows_torch

    quant_rows = quant_rows or _quant_rows_torch
    bits, arrays = buckets
    f = x.shape[1]
    src = torch.cat([x, x.new_zeros((1, f))]) if backward else x
    out = []
    for i, (b, quad) in enumerate(zip(bits, arrays)):
        idx = quad[2] if backward else quad[0]
        rows = src[idx]
        if trace is not None:
            trace[idx.reshape(-1)] = variance_proxy(rows, f).reshape(-1)
        k, cap, _ = rows.shape
        q, scale, rmin = quant_rows(rows.reshape(k * cap, f), b, f_true, keys[i])
        wire = pack_rows(to_width(q, pad_features(f_true)), b)
        pair = torch.stack([scale, rmin], dim=-1).to(torch.bfloat16).view(torch.uint8)
        out.append(torch.cat([wire, pair], dim=-1).reshape(k, cap, wire.shape[1] + 4))
    return out


def unframe_by_buckets(recv, buckets, f, f_true, out_len, backward=False, dequant_rows=None):
    """The receive side as the padded exchange composed it before, from
    each bucket's received ``[K, cap, bytes + 4]`` frames: the frame's
    split, ``unpack_rows``, ``dequant_rows`` (default the plain version)
    with the bf16 pair widened, ``true_columns``, then ``rows[recv_slot] =
    ...`` (forward) or ``index_add_`` into the owners' rows (backward), a
    spare row taking the sentinels: f32 ``[out_len, f]``."""
    import torch

    from adaqp_tpu_torch.ops.quant import pad_features, true_columns, unpack_rows
    from adaqp_tpu_torch.ops.quant_cuda import _dequant_rows_torch

    dequant_rows = dequant_rows or _dequant_rows_torch
    bits, arrays = buckets
    out = torch.zeros((out_len + 1, f), dtype=torch.float32, device=recv[0].device)
    for b, quad, buf in zip(bits, arrays, recv):
        k, cap, nb = buf.shape
        wire = buf[..., :-4].reshape(k * cap, nb - 4)
        p = buf[..., -4:].contiguous().view(torch.bfloat16).reshape(k * cap, 2).float()
        q = unpack_rows(wire, b, pad_features(f_true)).contiguous()
        rows = true_columns(dequant_rows(q, p[:, 0].contiguous(), p[:, 1].contiguous()),
                            f_true, f)
        dest = (quad[3] if backward else quad[1]).reshape(-1)
        if backward:
            out.index_add_(0, dest, rows)
        else:
            out[dest] = rows
    return out[:out_len]


def abs_sums(buf, fr, n_out, f):
    """Sum |terms| of each row a backward receive of ``buf`` on the lane
    tables ``fr`` adds into an ``[n_out, f]`` output (the scale of its
    rounding): each lane's plain row on a row of its own, then the absolute
    values added into the lanes' destinations."""
    import dataclasses

    import torch

    from adaqp_tpu_torch.ops.quant_cuda import _dequant_frames_torch

    own = dataclasses.replace(fr, dst=torch.arange(fr.n, device=buf.device))
    terms = _dequant_frames_torch(buf, own, torch.zeros(fr.n, f, device=buf.device))
    keep = fr.dst < n_out
    return torch.zeros(n_out, f, device=buf.device).index_add_(0, fr.dst[keep],
                                                               terms[keep].abs())


def holed(layout):
    """A block ``BlockDevice`` without its all-zero tiles (those
    ``block_layout`` gives the destination blocks with no dense tile), so
    those blocks have no tile."""
    import torch

    from adaqp_tpu_torch.ops import spmm_block as sb

    keep = layout.masks.flatten(1).any(dim=1)
    keep[int(layout.blk_ptr[-1]):] = False
    dst_blk = layout.dst_blk[keep]
    return sb.BlockDevice(layout.n, layout.n_pad, layout.n_src_pad,
                          layout.masks[keep].contiguous(), layout.src_start[keep].contiguous(),
                          dst_blk.contiguous(),
                          torch.as_tensor(sb.block_pointers(dst_blk.cpu().numpy(), layout.n_pad),
                                          device=layout.masks.device), None)


def hub_layout(rng, device):
    """A holed block layout on ``device`` in which destination block 0
    gathers from every one of 26 source windows (26 tiles, 832 K-steps
    through expand_spmm's ring of window stages), blocks 1-31 from a band
    of neighbours, and blocks 32-207 from nothing (no tile: zeros)."""
    from adaqp_tpu_torch.ops import spmm_block as sb

    n = 26 * 2048 - 300
    win = np.repeat(np.arange(26), 400)
    hub_src = np.minimum(win * 2048 + rng.integers(0, 2048, win.size), n - 1)
    hub_dst = rng.integers(0, 256, win.size)
    band_src = rng.integers(0, 8192, 60_000)
    band_dst = (band_src + rng.integers(-200, 200, band_src.size)) % 8192
    src = np.concatenate([hub_src, band_src]).astype(np.int32)
    dst = np.concatenate([hub_dst, band_dst]).astype(np.int32)
    return holed(sb.block_layout(src, dst, n, min_edges=64).to_device(device))
