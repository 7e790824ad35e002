"""Convert a single-journal data_dir to the per-shard segment layout.

Port of `tools/migrate_journal.py`.  The sharded control plane
(cook_tpu_torch/shard/) persists per shard:
`data_dir/shards/shard-NN/{snapshot.json,journal.jsonl}` plus a
versioned `manifest.json`.  A node started with `shards > 1` against an
old single-journal data_dir auto-migrates at startup; this tool is the
OFFLINE form: run it once against a stopped node's data_dir, inspect the
summary, then start the sharded node.

Idempotent: the manifest is the exactly-once marker; re-running reports
`already-sharded` and changes nothing.  The original snapshot.json /
journal.jsonl are renamed `*.premigrate` (kept for rollback and audit,
never replayed).  Host-only: nothing here touches the card.

    python -m cook_tpu_torch.tools.migrate_journal DATA_DIR --shards 4
    python -m cook_tpu_torch.tools.migrate_journal DATA_DIR --shards 4 --json
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="convert a single-journal data_dir to per-shard "
                    "journal segments (exactly once)")
    parser.add_argument("data_dir", help="the node's data directory")
    parser.add_argument("--shards", type=int, default=4,
                        help="shard count to partition into (>= 2)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable summary on stdout")
    args = parser.parse_args(argv)

    if not os.path.isdir(args.data_dir):
        print(f"migrate_journal: {args.data_dir} is not a directory",
              file=sys.stderr)
        return 2
    from cook_tpu_torch.shard.journal import migrate_single_journal

    try:
        summary = migrate_single_journal(args.data_dir, args.shards)
    except ValueError as e:
        print(f"migrate_journal: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summary, indent=1))
    elif summary["migrated"]:
        print(f"migrate_journal: {args.data_dir} -> {summary['shards']} "
              f"segments ({summary.get('jobs', 0)} jobs, "
              f"{summary.get('instances', 0)} instances; per-shard jobs "
              f"{summary.get('per_shard_jobs')}); originals kept as "
              f"*.premigrate")
    else:
        print(f"migrate_journal: nothing to do "
              f"({summary['reason']}, {summary['shards']} shards)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
