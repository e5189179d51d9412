"""Parallelism of the port: the single-card Mixture-of-Experts layer (:mod:`.moe`)."""
