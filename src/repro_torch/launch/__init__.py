"""Launchers of the port. ``train`` is the tuning launcher (AMT over real
training jobs); the JAX package's mesh, dry-run, hill-climb, roofline and
HLO tools wait for the port's sharding (ROADMAP A13)."""
