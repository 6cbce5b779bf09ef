"""irfinder_tpu_torch — the PyTorch/CUDA port of irfinder_tpu.

The device half of the engine in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (csrc/*.cu, built at first use).  The framework-free layers
(semantics, reference compiler, BAM decoders and writer, junction tally,
finalize join, table writers, QC, differential) are the port's own copies of
the JAX package's modules, in the same layout, with their C++ components
under csrc/host/; the tests hold each copy to its original.  This package
imports neither JAX nor ``irfinder_tpu``.

Ported so far: the single-sample ``-m BAM`` path (engine.run_bam, cli
``BAM``) with checkpoint/resume (checkpoint.py, ``--checkpoint``), batch mode
(engine.run_multi_bam, cli ``Batch``), both with the per-intron statistics
on the device, the FastQ pipeline (cli ``FastQ``: trim, an external
aligner's pipe, counting), and the dp x genome mesh (engine_mesh.run_bam_mesh,
cli ``BAM --mesh``; parallel/) with its checkpoint and the multi-process
merge over torch.distributed.
"""

__version__ = "0.1.0"
