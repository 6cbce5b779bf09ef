"""Checkpoint / resume for long counting runs: port of
irfinder_tpu/checkpoint.py onto torch tensors.

A run's whole accumulation state is the flat int32 counter tensor ``cnt``
(O(#introns + MBS); 2.4 GB at the whole-genome map), the small per-refid
``chr`` tensor and the host junction tally.  A snapshot stores them with the
decoder's resume token (io/bampy.py format, shared by both decoders), so a
resume seeks to the position after the last batch counted instead of
decoding the prefix again.  Snapshots without a token (the stream had given
none yet) resume by decoding again and skipping the batches already counted
(engine.run_bam).

The file is one uncompressed ``.npz``, written to ``<path>.tmp`` and then
``os.replace``d, with the JAX package's keys and layout, so a snapshot
written by either package resumes in the other.  Counter values are small,
so ``cnt`` is stored as int8 lanes, four to a little-endian uint32 word
(``cnt_words``), plus an exact escape list (``over_idx``, ``over_vals``) of
the values outside [-128, 127]: a quarter of the bytes to pull and to write.
``IRTPU_CKPT_PACK=0`` stores the raw ``cnt`` instead.

Two packs compute the same fields: ``pull_card`` packs on the counters'
device and pulls the packed words in one copy; ``pull_host`` pulls ``cnt``
whole and packs it with numpy.  ``save_checkpoint`` uses the card pack, the
faster of the two on the H100 at the whole-genome map (PERF.md).

A mesh state (engine_mesh.py) holds one counter pair per (dp, genome) cell.
Its snapshot has the JAX mesh's layout, ``cnt`` and ``chrn`` stacked
(dp, genome, ...), so it resumes only under the same ``--mesh`` shape, in
either package.  It is packed cell by cell, each cell on its own device
(``pull_cells``), so the stack may exceed the 2**31 words one pack takes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .junctions import JuncTally, coerce_tally


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def pack_host(a: np.ndarray) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """(words uint32, over_idx int64, over_vals int32) of an int32 array:
    little-endian int8 lanes in uint32 words, and the exact values of the
    positions outside [-128, 127]."""
    flat = np.asarray(a).reshape(-1)
    v8 = np.clip(flat, -128, 127).astype(np.int8)
    over = np.nonzero((flat > 127) | (flat < -128))[0]
    pad = (-v8.size) % 4
    if pad:
        v8 = np.concatenate([v8, np.zeros(pad, np.int8)])
    words = np.frombuffer(v8.tobytes(), np.uint32).copy()
    return words, over.astype(np.int64), flat[over].astype(np.int32)


def pack_card(cnt: torch.Tensor) -> torch.Tensor:
    """pack_host's fields, computed on ``cnt``'s device, as one int32 tensor
    there: [words | over_idx | over_vals].  ``cnt`` is int32, a multiple of
    4 long (the counter layout pads it to whole TILEs) and shorter than
    2**31, so every escape index fits an int32."""
    flat = cnt.reshape(-1)
    if cnt.dtype != torch.int32 or flat.numel() % 4 or flat.numel() >= 2**31:
        raise ValueError(f"pack_card takes int32 counters of 4k < 2**31 words, not {cnt.dtype} "
                         f"x {flat.numel()}")
    over = torch.nonzero((flat > 127) | (flat < -128)).squeeze(1)
    words = flat.clamp(-128, 127).to(torch.int8).view(torch.int32)
    return torch.cat([words, over.to(torch.int32), flat[over]])


def _split_packed(buf: np.ndarray, n_words: int) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    k = (buf.size - n_words) // 2
    return (
        buf[:n_words].view(np.uint32),
        buf[n_words : n_words + k].astype(np.int64),
        buf[n_words + k :],
    )


def pull_card(cnt: torch.Tensor) -> tuple:
    """The card pack, then one device-to-host copy of its buffer.  Returns
    (words, over_idx, over_vals, {"pack_s", "d2h_s"}).  The pack runs on the
    current stream, so it reads the counters after every step enqueued
    there before it."""
    t0 = time.perf_counter()
    buf = pack_card(cnt)
    _sync(buf)
    t1 = time.perf_counter()
    host = buf.cpu().numpy()
    t2 = time.perf_counter()
    return (*_split_packed(host, cnt.numel() // 4), {"pack_s": t1 - t0, "d2h_s": t2 - t1})


def pull_host(cnt: torch.Tensor) -> tuple:
    """One device-to-host copy of ``cnt``, then pack_host.  Returns what
    pull_card returns."""
    t0 = time.perf_counter()
    host = cnt.cpu().numpy()
    t1 = time.perf_counter()
    fields = pack_host(host)
    t2 = time.perf_counter()
    return (*fields, {"pack_s": t2 - t1, "d2h_s": t1 - t0})


def unpack_words(words: np.ndarray, shape, over_idx, over_vals) -> np.ndarray:
    """Inverse of the packs: uint32 words -> int32 counters of ``shape``."""
    size = int(np.prod(shape))
    flat = (
        np.frombuffer(np.ascontiguousarray(words).tobytes(), np.int8)[:size]
        .astype(np.int32)
    )
    if len(over_idx):
        flat[np.asarray(over_idx)] = np.asarray(over_vals)
    return flat.reshape(shape)


def _cells(x) -> tuple:
    """A counters entry -> (leading shape, its tensors in row-major order):
    one tensor (leading shape ()), or a mesh's nested [dp][genome] list of
    per-cell tensors (leading shape (dp, genome))."""
    if isinstance(x, torch.Tensor):
        return (), [x]
    return (len(x), len(x[0])), [t for row in x for t in row]


def pull_cells(cells: list, pull=pull_card) -> tuple:
    """``pull`` cell by cell, each on its own device, joined into the fields
    of one pack of the cells' row-major concatenation: each cell's length
    is a whole number of TILEs, so its words follow the previous cell's,
    and its escape indices are offset by the words before it, as int64 on
    the host (no 2**31 limit on the whole).  Returns what pull returns,
    with the seconds summed over the cells."""
    words, oidx, ovals = [], [], []
    info = {"pack_s": 0.0, "d2h_s": 0.0}
    base = 0
    for c in cells:
        w, i, v, part = pull(c)
        words.append(w)
        oidx.append(i.astype(np.int64) + base)
        ovals.append(v)
        base += c.numel()
        for k in info:
            info[k] += part[k]
    return np.concatenate(words), np.concatenate(oidx), np.concatenate(ovals), info


def save_checkpoint(path: str, st, pull=pull_card) -> dict:
    """Snapshot a SampleState: counters (packed by ``pull``), junction
    tally, batches counted, the BAM header's refid count and the decoder
    resume token.  Call it between steps, on the thread that enqueues them.
    A mesh state (engine_mesh.py: nested [dp][genome] lists of cell
    tensors) is stored as the JAX mesh stores it, ``cnt`` and ``chrn``
    stacked (dp, genome, ...), packed cell by cell (pull_cells).  Returns
    the seconds it took by part (pack_s, d2h_s, write_s), the file's bytes
    and the escape count."""
    keys, vals = coerce_tally(st.junc_tally).merged()  # (n,3)/(n,2) int64
    token = (
        np.frombuffer(st.resume_token, dtype=np.uint8) if st.resume_token else np.zeros(0, np.uint8)
    )
    lead, cnt = _cells(st.counters["cnt"])
    _, chrn = _cells(st.counters["chr"])
    shape = lead + tuple(cnt[0].shape)
    if os.environ.get("IRTPU_CKPT_PACK", "1") != "0":
        words, oidx, ovals, info = pull_cells(cnt, pull)
        fields = dict(
            cnt_words=words, over_idx=oidx, over_vals=ovals,
            cnt_shape=np.asarray(shape, np.int64),
        )
        info["escapes"] = int(oidx.size)
    else:
        t0 = time.perf_counter()
        fields = dict(cnt=np.stack([c.cpu().numpy() for c in cnt]).reshape(shape))
        info = {"pack_s": 0.0, "d2h_s": time.perf_counter() - t0, "escapes": 0}
    t0 = time.perf_counter()
    tmp = path + ".tmp"
    np.savez(
        tmp,
        chrn=np.stack([c.cpu().numpy() for c in chrn]).reshape(lead + tuple(chrn[0].shape)),
        junc_keys=keys,
        junc_vals=vals,
        batches_done=np.int64(st.metrics.batches),
        n_refids=np.int64(chrn[0].shape[-1] - 1),
        resume_token=token,
        **fields,
    )
    # np.savez appends .npz when missing
    actual_tmp = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(actual_tmp, path)
    info["write_s"] = time.perf_counter() - t0
    info["bytes"] = os.path.getsize(path)
    return info


def load_checkpoint(path: str):
    """Returns ((cnt, chr) ndarrays, JuncTally, batches_done, n_refids,
    resume_token-or-None) or None when no checkpoint exists."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "cnt_words" in z:
            cnt = unpack_words(
                z["cnt_words"], tuple(z["cnt_shape"]),
                z["over_idx"], z["over_vals"],
            )
        else:
            cnt = z["cnt"]
        if "chrn" not in z:
            raise ValueError(
                f"checkpoint {path} uses the old single-array counter layout "
                "(before the per-refid tally split); it cannot be resumed — "
                "delete it and rerun"
            )
        chrn = z["chrn"]
        tally = JuncTally()
        tally.add_rows(z["junc_keys"], z["junc_vals"])
        token = bytes(z["resume_token"].tobytes()) if "resume_token" in z else b""
        return (
            (cnt, chrn),
            tally,
            int(z["batches_done"]),
            int(z["n_refids"]),
            token or None,
        )


def restore_state(engine, ckpt):
    """A SampleState on ``engine``'s device out of a loaded checkpoint
    tuple.  Raises ValueError when the counter shapes are not the ones the
    engine's reference gives for the snapshot's refid count."""
    from .ops.step import CounterLayout

    (cnt, chrn), tally, batches_done, n_refids = ckpt[:4]
    token = ckpt[4] if len(ckpt) > 4 else None
    want_cnt = (CounterLayout.build(engine.dref).total,)
    if tuple(cnt.shape) != want_cnt or tuple(chrn.shape) != (n_refids + 1,):
        raise ValueError(
            "checkpoint counter shape mismatch: reference or refid count "
            f"changed ({want_cnt} vs {tuple(cnt.shape)})"
        )
    dev = engine.device
    st = engine.new_state(n_refids, counters={
        "cnt": torch.from_numpy(np.ascontiguousarray(cnt, np.int32)).to(dev),
        "chr": torch.from_numpy(np.ascontiguousarray(chrn, np.int32)).to(dev),
    })
    st.junc_tally = tally
    st.metrics.batches = batches_done
    st.resume_token = token
    return st
