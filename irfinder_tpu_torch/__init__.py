"""irfinder_tpu_torch — the PyTorch/CUDA port of irfinder_tpu.

The device half of the engine in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (csrc/, built at first use).  The framework-free layers
(reference compiler, BAM decoders, finalize join, table writers, QC) are
imported from ``irfinder_tpu`` as they are.  This package never imports JAX.

Ported so far: the single-sample ``-m BAM`` path (engine.run_bam, cli
``BAM``) and batch mode (engine.run_multi_bam, cli ``Batch``), both with the
per-intron statistics on the device.
"""

__version__ = "0.1.0"
