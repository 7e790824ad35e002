"""Sharded control plane.  Ported so far: `router.MisroutedKey` (the REST
layer answers it with 421) and `replica.evaluate_staleness` (a standby's
replica-read gate); the partitioned store, journal segments and
`ShardedJournalFollower` of the reference's `cook_tpu/shard/` wait for the
sharded-store slice."""
