"""Subscription-sharded matching over a mesh of card positions.

The counterpart of the JAX package's ``mqtt_tpu.parallel``: subscriptions
shard across the ``subs`` axis of a 2-D mesh (each shard holds its own
flat-hash index), PUBLISH batches split across the ``batch`` axis, and
every batch tile ends with the union of its shards' sid slots. The JAX
package drives its mesh from one process through ``shard_map``; so does
this package: one process, a grid of ``torch.device`` positions, and no
process group. Positions may repeat a device (``["cuda:0"] * 8`` holds
every shard on one card); the union over the ``subs`` axis is then the
kernel's own write into the gathered layout, and a device copy where a
tile's shards lie on other cards.
"""

from .sharded import Mesh, ShardedTorchMatcher, dryrun_multichip, make_mesh, shard_of

__all__ = ["Mesh", "ShardedTorchMatcher", "dryrun_multichip", "make_mesh", "shard_of"]
