"""`python -m cook_tpu_torch.tools.lint_metrics` and
`python -m cook_tpu_torch.tools.ci_checks`: the lint over the port's tree
is clean against docs/observability.md, with the catalog rows the port
leaves out by design listed with their reasons; it flags a synthetic gap
as the reference's does; and the CI pipeline runs the reference's steps in
the reference's order."""
import pathlib
import sys

import pytest

from cook_tpu_torch.tools import ci_checks, lint_metrics

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))

import ci_checks as ref_ci_checks  # noqa: E402
import lint_metrics as ref_lint  # noqa: E402

REPO_ROOT = str(pathlib.Path(__file__).parent.parent)

CATALOG = """# Observability

## Metric catalog

| name (registry) | type | labels | meaning |
|---|---|---|---|
| `kept.metric` | counter | - | registered |
| `gone.metric` | counter | - | registered by the reference only |
"""


def _tree(tmp_path, source, catalog=CATALOG):
    (tmp_path / "cook_tpu_torch").mkdir()
    (tmp_path / "cook_tpu_torch" / "a.py").write_text(source)
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "observability.md").write_text(catalog)
    return str(tmp_path)


def test_the_port_tree_is_clean_and_leaves_out_one_row():
    result = lint_metrics.lint_tree(REPO_ROOT)
    assert result.ok, "\n".join(result.errors)
    assert len(result.sites) > 100 and result.span_sites
    # the scan covers the port (its tools included), not the reference
    assert all("/cook_tpu_torch/" in s.path for s in result.sites)
    assert sorted(lint_metrics.LEFT_OUT) == [
        "matcher.device_fallback_cycles"]
    assert all(lint_metrics.LEFT_OUT.values())
    # without the list, the fallback ladder's row is the one gap
    errors = lint_metrics.lint_tree(REPO_ROOT, left_out={}).errors
    assert len(errors) == 1
    assert "'matcher.device_fallback_cycles'" in errors[0]
    assert lint_metrics.main([REPO_ROOT]) == 0


def test_flags_an_undocumented_metric_like_the_reference(tmp_path):
    root = _tree(tmp_path, "global_registry.counter('kept.metric', 'h')\n"
                           "global_registry.counter('gone.metric', 'h')\n"
                           "global_registry.gauge('new.metric', 'h')\n")
    result = lint_metrics.lint_tree(root, left_out={})
    assert len(result.errors) == 1 and "new.metric" in result.errors[0]
    # the reference's linter on the same tree, laid out as its package
    (tmp_path / "cook_tpu_torch").rename(tmp_path / "cook_tpu")
    assert ref_lint.lint_tree(root).errors == [
        e.replace("cook_tpu_torch", "cook_tpu") for e in result.errors]


@pytest.mark.parametrize("left_out, stale", [
    ({}, ["gone.metric"]),
    ({"gone.metric": "why"}, []),
    ({"gone.metric": "why", "kept.metric": "why"}, ["kept.metric"]),
], ids=["gap", "excused", "stale-entry"])
def test_left_out_rows_are_excused_and_stale_entries_flagged(
        tmp_path, left_out, stale):
    root = _tree(tmp_path, "global_registry.counter('kept.metric', 'h')\n")
    errors = lint_metrics.lint_tree(root, left_out=left_out).errors
    assert len(errors) == len(stale)
    for error, name in zip(errors, stale):
        assert repr(name) in error


def test_conflicting_types_and_bad_spans_fail_the_cli(tmp_path):
    dirty = tmp_path / "dirty"
    dirty.mkdir()
    (dirty / "a.py").write_text("global_registry.counter('n', 'h')\n"
                                "global_registry.gauge('n', 'h')\n")
    assert lint_metrics.main([str(dirty)]) == 1
    spans = tmp_path / "spans"
    spans.mkdir()
    (spans / "a.py").write_text("span('Bad-Name')\n")
    assert lint_metrics.main([str(spans)]) == 1


# --------------------------------------------------------------- ci_checks


def _run(module, argv, codes=None):
    calls = []

    def step(name):
        def fn():
            calls.append(name)
            return (codes or {}).get(name, 0)
        return fn

    steps = {name: step(name) for name in ci_checks.STEPS}
    return module.main(argv, steps=steps), calls


@pytest.mark.parametrize("argv", [[], ["--skip-bench"]],
                         ids=["all", "skip-bench"])
def test_ci_steps_are_the_references_in_order(argv):
    code, calls = _run(ci_checks, ["--root", REPO_ROOT, *argv])
    ref_code, ref_calls = _run(ref_ci_checks, ["--root", REPO_ROOT, *argv])
    assert (code, calls) == (ref_code, ref_calls) == (0, calls)
    assert calls == (["lint_metrics"] if argv else list(ci_checks.STEPS))


def test_ci_failure_does_not_mask_later_steps_and_skips_fail_nothing(
        capsys):
    code, calls = _run(ci_checks, ["--root", REPO_ROOT],
                       codes={"lint_metrics": 1, "smoke_bench": None,
                              "bench_gate": None})
    assert code == 1 and calls == list(ci_checks.STEPS)
    out = capsys.readouterr().out
    assert "ci_checks: lint_metrics: FAIL (exit 1)" in out
    assert "ci_checks: smoke_bench: SKIP" in out
    assert "ci_checks: FAILED: lint_metrics\n" in out
    code, _ = _run(ci_checks, ["--root", REPO_ROOT],
                   codes={"smoke_bench": None, "bench_gate": None})
    assert code == 0


def test_ci_bench_steps_run_nothing_and_the_lint_step_is_real(capsys):
    assert ci_checks.run_smoke_bench(REPO_ROOT) is None
    assert ci_checks.run_bench_gate(REPO_ROOT, 0.2) is None
    out = capsys.readouterr().out
    assert out.count("no benchmark yet (ROADMAP.md N1)") == 2
    assert ci_checks.run_lint(REPO_ROOT) == 0


def test_ci_step_exception_counts_as_failure():
    steps = {name: (lambda: 0) for name in ci_checks.STEPS}
    steps["chaos_smoke"] = lambda: 1 / 0
    assert ci_checks.main(["--root", REPO_ROOT], steps=steps) == 1
