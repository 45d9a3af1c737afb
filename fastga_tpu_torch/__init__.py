"""fastga_tpu_torch — the PyTorch/CUDA port of fastga_tpu, a whole-genome
aligner with the capabilities of FastGA, for one NVIDIA H100 or several.

The FastGA pipeline (reference: thegenemyers/FASTGA, C99), on the card:

  FASTA -> GDB (2-bit genome database)            fastga_tpu_torch.io.gdb
        -> GIX (syncmer-sampled k-mer index)      fastga_tpu_torch.ops.syncmer / io.gix
        -> adaptamer seed merge                   fastga_tpu_torch.ops.device_pipeline
        -> seed sort + chain detection            fastga_tpu_torch.ops.device_pipeline
        -> batched O(nd) wavefront local aligner  fastga_tpu_torch.ops.wave
        -> dedup + trace-point .1aln output       fastga_tpu_torch.models.aligner / io.alncode

Host-side IO (ONEcode container, GDB, GIX, .1aln) lives in
``fastga_tpu_torch.io``; device compute in ``fastga_tpu_torch.ops`` (each
kernel a hand-written CUDA source under ``csrc/`` behind a wrapper with a
plain PyTorch version for the CPU); the seed pipeline over several ranks of
``torch.distributed`` in ``fastga_tpu_torch.parallel``; CLI tools in
``fastga_tpu_torch.cli``.
"""

__version__ = "0.1.0"
