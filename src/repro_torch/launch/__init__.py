"""Launch layer of the port, in local mode: the serving and training CLIs
and the donation tables.

Mirrors ``repro/launch``. The reference's production meshes, AOT dry-run
and hill-climb tooling read XLA HLO and are not ported yet."""
