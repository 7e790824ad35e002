"""`python -m cook_tpu_torch.tools.migrate_journal` against the reference's
`tools/migrate_journal.py`: from one single-journal data_dir, the same
summary (text and `--json`) and the same per-shard segment files, byte
for byte."""
import filecmp
import json
import os
import pathlib
import shutil
import sys

import pytest

from cook_tpu_torch.models import persistence
from cook_tpu_torch.models.entities import Job, Pool, Resources
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.shard import ShardRouter
from cook_tpu_torch.shard import journal as shard_journal
from cook_tpu_torch.tools import migrate_journal

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))

import migrate_journal as ref_migrate  # noqa: E402


def single_journal_dir(path, n_jobs=12):
    """A stopped node's single-journal data_dir: jobs over one pool per
    shard, an instance, an idempotency record, on a fixed clock."""
    os.makedirs(path)
    store = JobStore(clock=lambda: 1_700_000_000_000)
    journal = persistence.attach_journal(store,
                                         os.path.join(path, "journal.jsonl"))
    pools = ShardRouter(4).pools_for_distinct_shards()
    for name in pools:
        store.set_pool(Pool(name=name))
    store.submit_jobs([Job(uuid=f"m{i:02d}", user=f"u{i % 3}",
                           pool=pools[i % 4], command="true",
                           resources=Resources(mem=64, cpus=1))
                       for i in range(n_jobs)])
    store.create_instance("m00", "mt0", hostname="h0")
    store.note_txn("txn-old", "jobs/submit", {"jobs": ["m00"]})
    journal.close()
    return store


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_same_summary_and_segments_as_the_reference(tmp_path, capsys,
                                                    as_json):
    source = single_journal_dir(str(tmp_path / "src"))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(str(tmp_path / "src"), ref_dir)
    shutil.copytree(str(tmp_path / "src"), port_dir)
    flags = ["--shards", "4"] + (["--json"] if as_json else [])
    assert ref_migrate.main([ref_dir, *flags]) == 0
    want = capsys.readouterr().out.replace(ref_dir, "DIR")
    assert migrate_journal.main([port_dir, *flags]) == 0
    got = capsys.readouterr().out.replace(port_dir, "DIR")
    assert got == want
    if as_json:
        summary = json.loads(got)
        assert summary["migrated"] and summary["jobs"] == 12
        assert sum(summary["per_shard_jobs"]) == 12
    else:
        assert got.startswith("migrate_journal: DIR -> 4 segments (12 jobs")
    assert _tree(port_dir) == _tree(ref_dir)
    for rel in _tree(ref_dir):
        assert filecmp.cmp(os.path.join(port_dir, rel),
                           os.path.join(ref_dir, rel), shallow=False), rel
    # read back whole, as the sharded node recovers it
    recovered = shard_journal.recover_sharded(port_dir, 4)
    assert set(recovered.jobs) == set(source.jobs)
    assert recovered.job_instances("m00")[0].task_id == "mt0"
    # exactly once: a second run changes nothing, in both tools' words
    assert ref_migrate.main([ref_dir, "--shards", "4"]) == 0
    want = capsys.readouterr().out.replace(ref_dir, "DIR")
    assert migrate_journal.main([port_dir, "--shards", "4"]) == 0
    assert capsys.readouterr().out.replace(port_dir, "DIR") == want
    assert "nothing to do (already-sharded, 4 shards)" in want


def test_refusals_match_the_reference(tmp_path, capsys):
    missing = str(tmp_path / "nope")
    assert migrate_journal.main([missing]) == ref_migrate.main([missing]) \
        == 2
    err = capsys.readouterr().err.replace(missing, "DIR").splitlines()
    assert err[0] == err[1] == "migrate_journal: DIR is not a directory"
    single_journal_dir(str(tmp_path / "one"))
    assert migrate_journal.main([str(tmp_path / "one"), "--shards",
                                 "1"]) == 2
    assert "migrate_journal: migration target must be >= 2 shards" in \
        capsys.readouterr().err
