"""The helper scripts of the repository's scripts/ directory that use
the package, as modules of the port (their logic unchanged, their
imports the port's):

    python -m delly_tpu_torch.scripts.delly2bnd -v a.vcf -r ref.fa -o b.vcf
    python -m delly_tpu_torch.scripts.mergegeno -o all.bcf g0.bcf g1.bcf
"""
