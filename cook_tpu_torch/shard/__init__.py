"""Sharded control plane.  Only `router.MisroutedKey` is ported so far
(the REST layer answers it with 421); the partitioned store, journal
segments and replicas of the reference's `cook_tpu/shard/` wait for the
control-plane slice."""
