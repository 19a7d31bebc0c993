"""Helpers that several of the port's test files share (not collected as
tests): random edge lists, the small strip layouts the strip kernel's walk
must take, and a launch of two CPU ranks beside the caller's JAX training.
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
