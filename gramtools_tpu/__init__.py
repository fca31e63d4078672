"""gramtools_tpu: an accelerator-native genome-graph genotyping framework.

Re-implements the capabilities of gramtools (iqbal-lab-org/gramtools):
PRG construction, vBWT/FM-index build, quasimap (variant-aware backward
search), coverage recording, level genotyping, VCF/jVCF output,
personalised reference, simulate and discover -- designed from scratch
for JAX/XLA on an NVIDIA GPU, with host-side orchestration in Python and native
C++ for the build-time heavy lifting.

Layering (bottom-up):
  common/    core codecs, RNG, IO, reports, paths
  prg/       linearised PRG + coverage graph (structure-of-arrays)
  index/     suffix array, FM/occ tables, kmer index (build artifacts)
  mapping/   quasimap: vBWT search (host reference + batched JAX engine),
             coverage recording, read stats
  infer/     allele extraction, level genotyping model/runner, outputs
  commands/  CLI surface (build, genotype, discover, simulate)
  parallel/  device mesh sharding: data-parallel reads, psum coverage
"""

__version__ = "0.1.0"

BYTES_PER_INT = 4  # linear PRG serialisation width (matches gramtools/__init__.py:16-22)
ENDIANNESS = "little"
