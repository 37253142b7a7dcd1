"""Launchers of the port.

* ``train`` — the tuning launcher (AMT over real training jobs);
* ``mesh`` — the production (16×16, 2×16×16) and local meshes over the
  current process group;
* ``roofline`` — hardware targets (the H100 SXM; the reference's TPU v5e
  for the twins), analytic parameter counts and model FLOPs, roofline terms;
* ``op_analysis`` — per-device FLOPs, bytes, collectives, op census and
  peak live storage of one traced step (the role of the JAX package's
  ``hlo_analysis`` and ``hlo_static``);
* ``dryrun`` — the production-mesh dry-run over a fake process group;
* ``hillclimb`` — the reference's §Perf variants over the port's dry-run.
"""
