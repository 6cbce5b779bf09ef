"""Multi-process execution: port of irfinder_tpu/parallel/multihost.py over
torch.distributed.

One process per host (or per card), each a MeshEngine over its own local
devices, all running the same counting program:

* every process counts its round-robin share of the batch stream
  (``host_local_batches``: batch i goes to process i mod P) into its local
  cells;
* the merge sums each genome shard's counters over the processes, one
  integer ``all_reduce(SUM)`` per tensor after the local dp merge, and
  gathers every process's junction tally (``merge_processes``); the state
  then finalizes as one process's;
* ``run_bam_multihost`` is the whole path: count, merge, and process 0
  writes the full table set.

Counters are integers, so the sums are exact and the tables are the same at
any process count.  The process group is gloo for CPU devices and NCCL
between cards, one card per process (``initialize``).  This is the only
module of the port that uses torch.distributed: one process drives all of
its cells itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..engine import open_decoder, write_run
from ..engine_mesh import MeshEngine, mesh_devices
from ..junctions import JuncTally
from .shard import on_device


def initialize(coordinator: str, num_processes: int, process_id: int, device="cuda") -> None:
    """Join the process group: ``coordinator`` is its rendezvous, an init
    method URL (``tcp://host:port`` or ``file:///path``; a bare
    ``host:port`` means tcp), ``num_processes`` the world size and
    ``process_id`` this process's rank.  The backend is NCCL when ``device``
    is a card, else gloo.  Nothing on a host tells a program of a cluster,
    so all three are given explicitly."""
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)


def host_local_batches(batches, process_index: int | None = None, num_processes: int | None = None):
    """Round-robin split of a batch stream across processes: process p takes
    batch indices ≡ p (mod P).  Deterministic and order-preserving per
    process; add-associative counters make the interleaving irrelevant."""
    p = dist.get_rank() if process_index is None else process_index
    P = dist.get_world_size() if num_processes is None else num_processes
    for i, b in enumerate(batches):
        if i % P == p:
            yield b


def count_local_share(eng, batches, n_refids: int):
    """The counterpart of the JAX package's global_mesh + make_global_batch:
    this process's MeshEngine (its local cells) counts its round-robin share
    of ``batches``.  Returns its SampleState."""
    st = eng.new_state(n_refids)
    eng.run_stream(host_local_batches(batches), st)
    return st


def merge_processes(eng, st) -> None:
    """Make ``st`` hold every process's counts, in place: each genome
    shard's counters summed over the local dp cells into its dp-0 cell (the
    other cells zeroed), then over the processes by all_reduce; the
    junction tallies' rows gathered into one JuncTally.  The metrics stay
    this process's.  Collective: every process calls it."""
    rows = st.counters
    for k in ("cnt", "chr"):
        for g in range(eng.spec.genome):
            acc = rows[k][0][g]
            with on_device(acc.device):
                for i in range(1, eng.spec.dp):
                    acc += rows[k][i][g].to(acc.device)
                    rows[k][i][g].zero_()
                dist.all_reduce(acc, op=dist.ReduceOp.SUM)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, st.junc_tally.merged())
    gap_rows = st.junc_tally.gap_rows
    st.junc_tally = JuncTally()
    st.junc_tally.gap_rows = gap_rows
    for keys, vals in gathered:
        st.junc_tally.add_rows(keys, vals)


def run_bam_multihost(ref, bam, out_dir: str, spec, devices=None, cap_frags: int = 1 << 15, device="cuda"):
    """``-m BAM --mesh`` over the process group: every process decodes
    ``bam`` and counts its round-robin share of the batches on a local mesh
    of shape ``spec`` (its cells on ``devices``, engine_mesh.mesh_devices),
    the counts are merged over the processes, and process 0 writes the full
    table set to ``out_dir`` (byte-identical to the unsharded run_bam).
    Collective: every process calls it.  Returns this process's metrics."""
    eng = MeshEngine(ref, spec, mesh_devices(spec, devices, device), cap_frags=cap_frags)
    header, batches, stats = open_decoder(ref, bam, cap_frags)
    st = count_local_share(eng, batches, len(header.ref_names))
    merge_processes(eng, st)
    if dist.get_rank() == 0:
        write_run(out_dir, ref, header, stats, st, eng.results_async(st))
    return st.metrics
