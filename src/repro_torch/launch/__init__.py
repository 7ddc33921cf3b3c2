"""Launch layer of the port: the serving and training CLIs (local mode),
the donation tables, and the dry-run tooling, which traces a production
cell's step on ``meta`` tensors (``mesh``, ``cells``, ``roofline``,
``op_costs``, ``comm``, ``dryrun``, ``hillclimb``).

Mirrors ``repro/launch``."""
