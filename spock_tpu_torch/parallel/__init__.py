"""The distribution layer on ``torch.distributed``: lane sharding and
process meshes (:mod:`.mesh`), node-sharded solves of one large tree
(:mod:`.bigtree`)."""

from . import mesh  # noqa: F401
