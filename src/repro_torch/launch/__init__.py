"""Launch layer of the port: the serving CLI (local mode).

Mirrors ``repro/launch``. The reference's production meshes, AOT dry-run
and hill-climb tooling read XLA HLO and are not ported yet; neither is
the training CLI."""
