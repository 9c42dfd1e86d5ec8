"""The port's examples, the counterparts of ``examples/``: conjugate
gradient with SSOR (:mod:`.cg`), ILU(0)-preconditioned GMRES on a
convection-diffusion operator (:mod:`.convection_ilu`) and PageRank on a
power-law graph (:mod:`.pagerank`). Each runs on the card, or with
``--device cpu`` on the kernels' plain versions:

    python -m sblas_torch.examples.cg [n] [--device cpu]
"""
