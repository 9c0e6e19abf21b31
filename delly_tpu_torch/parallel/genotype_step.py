"""Multi-chip sr genotyping: the production pipeline under a mesh.

Round 1 kept a standalone shard-level re-implementation of the
genotyping math here; it drifted from the production kernel (REF-count
halving, flank quality, read caps) and is deleted. The sharded step now
IS the production code path: ``models/genotype_sr._process_jobs_device``
(and every other batched-distance consumer: assembly all-pairs, lr
probe scoring) routes its kernel through ``parallel.dispatch`` when a
mesh is active, so there is exactly one implementation of the hot loop
(reference coverage.h:412-454) and an N-device run is byte-identical to
a 1-device run (tests/test_multichip.py asserts this on the example
data over an 8-virtual-device CPU mesh).
"""

from __future__ import annotations

import os
import tempfile

from delly_tpu_torch.parallel import dispatch


def run_sr_on_mesh(mesh, bam_path: str, genome_path: str,
                   out_path: str | None = None) -> str:
    """Run the FULL production `sr` pipeline (scan -> cluster ->
    assembly -> refine -> genotype -> VCF) with its batched kernels
    executed across `mesh`. Returns the VCF text."""
    from delly_tpu_torch.models.config import SrConfig
    from delly_tpu_torch.models.sr import run_sr

    tmp = None
    if out_path is None:
        fd, tmp = tempfile.mkstemp(suffix=".vcf")
        os.close(fd)
        out_path = tmp
    try:
        cfg = SrConfig(genome=genome_path, files=[bam_path],
                       outfile=out_path)
        with dispatch.use_mesh(mesh):
            rc = run_sr(cfg)
        if rc != 0:
            raise RuntimeError(f"sr pipeline failed (rc={rc})")
        with open(out_path) as fh:
            return fh.read()
    finally:
        if tmp is not None:
            os.unlink(tmp)
