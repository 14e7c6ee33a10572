"""Probes of kernel variants, run as ``python -m
topopteval_tpu_torch.tools.<name>``: ``ke_probe`` (two formulations of
the Tet4 Ke batch against the production kernel) and ``ell_ablate`` (the
block-ELL matvec's gather and value stages taken apart)."""
