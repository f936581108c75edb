"""Control plane of the PyTorch port: a copy of the JAX package's ``core/``
(Slurm simulation, microservices, gateway, router, autoscaler, reconciler)
that drives the port's ``LLMEngine``."""
