#!/usr/bin/env python
"""Static metrics + tracing lint: every registration site must agree.

Port of `tools/lint_metrics.py`, over the port's tree
(`cook_tpu_torch/`, its tools included) against the same
`docs/observability.md` catalog.  The catalog documents the reference, so
its rows for what the port leaves out by design are `LEFT_OUT`, each with
its reason, as the coverage test's `ALLOWED` list does for functions
(`tests/test_torch_coverage.py`); an entry whose row no longer needs it
fails, so the list stays exact.

The registry raises at RUNTIME when one name is requested as two
different metric types — but only when the second call site actually
executes, which for cold paths can be mid-incident.  This linter walks
the source tree instead and fails when:

  * the same metric name is registered with conflicting types
    (e.g. `counter("match.matched")` in one file and
    `gauge("match.matched")` in another);
  * a literal metric name does not render to a valid Prometheus
    identifier under the exposition mapping
    (`cook_` + name with `.`/`-` -> `_`);
  * a metric name is registered WITHOUT HELP text anywhere (every name
    needs at least one site passing the help argument — an exposition
    without `# HELP` is a metric nobody can interpret mid-incident);
  * a tracing span name (`span(...)` / `record_event(...)` literal)
    doesn't match `^[a-z0-9_.]+$` (span names become
    `cook_span_<name>` histograms and ring entries — one flat grammar);
  * the same span name is introduced from more than one module (each
    span has one owner; a shared name would merge two different
    sections into one histogram with nobody noticing);
  * **doc drift** — a literal metric name registered in code does not
    appear in the docs/observability.md catalog (exact backticked name,
    or a documented `prefix.*` wildcard).  A metric nobody documented
    is a metric nobody can interpret mid-incident; the catalog is the
    contract, so it must grow WITH the code.  Only checked when the
    linted root carries docs/observability.md (arbitrary-directory
    lints skip it);
  * **reverse doc drift** — the mirror direction: a metric-catalog
    TABLE row (the "## Metric catalog" section only; prose backticks
    elsewhere are not rows) whose family is no longer registered
    anywhere in the code fails, honoring the same `family.*` wildcard
    convention — a stale row sends the mid-incident reader hunting for
    a metric that no longer exists, so the catalog must also SHRINK
    with the code.

Aliased registrations (`g = global_registry.gauge; g("name", ...)`) are
resolved file-locally, so the monitor-gauge idiom stays covered.
Dynamic names (f-strings like `f"span.{name}"`) can't be validated
statically; their constant fragments are still checked for characters
that could never be valid, and dynamic metric sites must each carry
help (they can't be vouched for by a sibling site).

Run in the CPU tests by tests/test_torch_tools_lint.py.

    python -m cook_tpu_torch.tools.lint_metrics [root]
"""
from __future__ import annotations

import ast
import pathlib
import re
import sys
from dataclasses import dataclass, field

METRIC_FACTORIES = ("counter", "gauge", "histogram")
SPAN_FUNCTIONS = ("span", "record_event")
_VALID_RENDERED = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
# characters a name fragment may use pre-mapping (".", "-" map to "_")
_VALID_FRAGMENT = re.compile(r"[a-zA-Z0-9_:.\-]*$")
_VALID_SPAN = re.compile(r"[a-z0-9_.]+$")
_VALID_SPAN_FRAGMENT = re.compile(r"[a-z0-9_.]*$")


# catalog rows of docs/observability.md that name what the port leaves
# out by design: {metric name: reason}
LEFT_OUT = {
    "matcher.device_fallback_cycles": (
        "the device-fallback ladder (ROADMAP.md, Deliberately not "
        "ported): the port re-solves nothing on the CPU, so it counts no "
        "fallback cycles; a failed solve shows as health device-degraded"),
}


def rendered_name(name: str) -> str:
    """The exposition-time mapping: a standalone copy of
    cook_tpu_torch/utils/metrics.prometheus_name (this linter must run
    against arbitrary trees without importing the package)."""
    return "cook_" + name.replace(".", "_").replace("-", "_")


@dataclass
class CallSite:
    path: str
    line: int
    metric_type: str
    name: str            # literal, or the constant fragments of an f-string
    dynamic: bool = False
    has_help: bool = False


@dataclass
class SpanSite:
    path: str
    line: int
    name: str
    dynamic: bool = False


@dataclass
class LintResult:
    sites: list[CallSite] = field(default_factory=list)
    span_sites: list[SpanSite] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def _is_global_registry(node: ast.expr) -> bool:
    # global_registry.counter(...) or <mod>.global_registry.counter(...)
    if isinstance(node, ast.Name):
        return node.id == "global_registry"
    if isinstance(node, ast.Attribute):
        return node.attr == "global_registry"
    return False


def _name_arg(call: ast.Call,
              consts: dict[str, str] | None = None) -> tuple[str, bool] | None:
    """(name, dynamic) from the first positional arg; None when it isn't
    a string-ish literal at all (a variable — nothing to check).  A bare
    name bound to a file-local string constant (`_NAME = "a.b"` ...
    `gauge(_NAME, ...)`) resolves through `consts` — without this the
    constant-name idiom hides a registration from BOTH doc-drift
    directions."""
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.Name) and consts and arg.id in consts:
        return consts[arg.id], False
    if isinstance(arg, ast.JoinedStr):
        fragments = [v.value for v in arg.values
                     if isinstance(v, ast.Constant) and isinstance(v.value, str)]
        return "".join(fragments), True
    return None


def _has_help(call: ast.Call) -> bool:
    """True when the registration passes non-empty help (2nd positional
    or help_= keyword) — "can't tell statically" (a variable) counts as
    help, only a knowably-empty/missing argument fails."""
    arg = None
    if len(call.args) >= 2:
        arg = call.args[1]
    else:
        for kw in call.keywords:
            if kw.arg == "help_":
                arg = kw.value
    if arg is None:
        return False
    if isinstance(arg, ast.Constant):
        return bool(arg.value)
    return True


def _registry_aliases(tree: ast.AST) -> dict[str, str]:
    """File-local names bound to a registry factory
    (`g = global_registry.gauge` -> {"g": "gauge"})."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        if (isinstance(value, ast.Attribute)
                and value.attr in METRIC_FACTORIES
                and _is_global_registry(value.value)):
            aliases[node.targets[0].id] = value.attr
    return aliases


def _string_constants(tree: ast.AST) -> dict[str, str]:
    """File-local names bound (once) to a string literal
    (`_NAME = "shard.x"` -> {"_NAME": "shard.x"}).  Re-bound names are
    dropped — an ambiguous binding must not vouch for a name."""
    consts: dict[str, str] = {}
    rebound: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        target = node.targets[0].id
        if target in consts or target in rebound:
            rebound.add(target)
            consts.pop(target, None)
            continue
        if isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            consts[target] = node.value.value
    return consts


def _is_span_call(func: ast.expr) -> bool:
    # span(...) / record_event(...) / tracing.span(...) /
    # <mod>.tracing.record_event(...)
    if isinstance(func, ast.Name):
        return func.id in SPAN_FUNCTIONS
    if isinstance(func, ast.Attribute) and func.attr in SPAN_FUNCTIONS:
        value = func.value
        if isinstance(value, ast.Name):
            return value.id == "tracing"
        if isinstance(value, ast.Attribute):
            return value.attr == "tracing"
    return False


def collect_sites(source: str, path: str) -> list[CallSite]:
    sites: list[CallSite] = []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return sites
    aliases = _registry_aliases(tree)
    consts = _string_constants(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        metric_type = None
        if (isinstance(func, ast.Attribute)
                and func.attr in METRIC_FACTORIES
                and _is_global_registry(func.value)):
            metric_type = func.attr
        elif isinstance(func, ast.Name) and func.id in aliases:
            metric_type = aliases[func.id]
        if metric_type is None:
            continue
        parsed = _name_arg(node, consts)
        if parsed is None:
            continue
        name, dynamic = parsed
        sites.append(CallSite(path=path, line=node.lineno,
                              metric_type=metric_type, name=name,
                              dynamic=dynamic, has_help=_has_help(node)))
    return sites


def collect_span_sites(source: str, path: str) -> list[SpanSite]:
    sites: list[SpanSite] = []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return sites
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_span_call(node.func)):
            continue
        parsed = _name_arg(node)
        if parsed is None:
            continue
        name, dynamic = parsed
        sites.append(SpanSite(path=path, line=node.lineno, name=name,
                              dynamic=dynamic))
    return sites


def lint_sites(sites: list[CallSite],
               span_sites: list[SpanSite] = ()) -> LintResult:
    result = LintResult(sites=sites, span_sites=list(span_sites))
    by_name: dict[str, dict[str, list[CallSite]]] = {}
    for site in sites:
        where = f"{site.path}:{site.line}"
        if site.dynamic:
            # can't validate the whole name; the constant fragments must
            # still be mappable — and help can't be vouched for by a
            # sibling site, so each dynamic site carries its own
            if not _VALID_FRAGMENT.match(site.name):
                result.errors.append(
                    f"{where}: dynamic metric name has invalid constant "
                    f"fragment {site.name!r}")
            if not site.has_help:
                result.errors.append(
                    f"{where}: dynamic metric f\"...{site.name}...\" "
                    f"registered without HELP text")
            continue
        pname = rendered_name(site.name)
        if not _VALID_RENDERED.match(pname):
            result.errors.append(
                f"{where}: metric {site.name!r} renders to invalid "
                f"Prometheus identifier {pname!r}")
        by_name.setdefault(site.name, {}).setdefault(
            site.metric_type, []).append(site)
    for name, types in sorted(by_name.items()):
        if len(types) > 1:
            locations = "; ".join(
                f"{t}@" + ",".join(f"{s.path}:{s.line}" for s in ss)
                for t, ss in sorted(types.items()))
            result.errors.append(
                f"metric {name!r} registered with conflicting types: "
                f"{locations}")
        all_sites = [s for ss in types.values() for s in ss]
        if not any(s.has_help for s in all_sites):
            locations = ",".join(f"{s.path}:{s.line}" for s in all_sites)
            result.errors.append(
                f"metric {name!r} registered without HELP text at every "
                f"site ({locations}); add help to at least one")
    _lint_spans(result)
    return result


def _lint_spans(result: LintResult) -> None:
    """Span-name rules: flat `^[a-z0-9_.]+$` grammar, one owning module
    per name (a span name reused across files merges two different code
    sections into one histogram)."""
    by_name: dict[str, list[SpanSite]] = {}
    for site in result.span_sites:
        where = f"{site.path}:{site.line}"
        if site.dynamic:
            if not _VALID_SPAN_FRAGMENT.match(site.name):
                result.errors.append(
                    f"{where}: dynamic span name has invalid constant "
                    f"fragment {site.name!r}")
            continue
        if not _VALID_SPAN.match(site.name):
            result.errors.append(
                f"{where}: span name {site.name!r} does not match "
                f"^[a-z0-9_.]+$")
        by_name.setdefault(site.name, []).append(site)
    for name, sites in sorted(by_name.items()):
        files = sorted({s.path for s in sites})
        if len(files) > 1:
            result.errors.append(
                f"span {name!r} opened from multiple modules "
                f"({', '.join(files)}); give each span one owner (or "
                f"hoist a shared helper)")


DOC_CATALOG = pathlib.Path("docs") / "observability.md"
# a backticked doc token that can name a registry metric: the literal
# name, or a trailing-`*` wildcard row covering a family
# (`monitor.*`, `obs.device.mem_*`)
_DOC_NAME = re.compile(r"`([a-zA-Z0-9_][a-zA-Z0-9_.\-]*\*?)`")


def documented_names(doc_text: str) -> tuple[set[str], list[str]]:
    """(exact names, wildcard prefixes) the catalog vouches for.  A
    `monitor.*` row covers every `monitor.`-prefixed registration."""
    exact: set[str] = set()
    prefixes: list[str] = []
    for token in _DOC_NAME.findall(doc_text):
        if token.endswith("*"):
            prefixes.append(token[:-1])
        else:
            exact.add(token)
    return exact, prefixes


def lint_doc_coverage(result: LintResult, doc_text: str,
                      doc_path: str) -> None:
    """Fail literal metric registrations missing from the catalog.
    Dynamic names can't be matched exactly and are skipped (their
    fragments were already character-checked)."""
    exact, prefixes = documented_names(doc_text)
    missing: dict[str, CallSite] = {}
    for site in result.sites:
        if site.dynamic or site.name in exact or site.name in missing:
            continue
        if any(site.name.startswith(p) for p in prefixes):
            continue
        missing[site.name] = site
    for name, site in sorted(missing.items()):
        result.errors.append(
            f"{site.path}:{site.line}: metric {name!r} is not in the "
            f"{doc_path} catalog (add a row, or a `family.*` wildcard)")


# the reverse direction is scoped to the catalog TABLE (the section
# below this heading): the rest of the doc backticks plenty of
# non-metric tokens (paths, config keys) that must not be "checked"
_CATALOG_HEADING = "## Metric catalog"
# a catalog-row token: a metric name, optionally with an
# `<angle-bracket>` placeholder segment (`span.<name>`,
# `obs.device.mem_<kind>`) or a trailing `*` — either marks the
# constant head as a wildcard prefix
_ROW_NAME = re.compile(
    r"`([a-zA-Z0-9_][a-zA-Z0-9_.\-]*)(<[a-zA-Z_]+>[a-zA-Z0-9_.\-]*|\*)?`")


def catalog_rows(doc_text: str) -> list[tuple[int, list[str]]]:
    """(line number, first-cell metric tokens) for every table row in
    the metric-catalog section.  A row's first cell may carry several
    names (`journal.appends` / `journal.bytes_written`); a placeholder
    segment (`span.<name>`) normalizes to a `head.*` wildcard token so
    the dynamic-family idiom is actually checked, not skipped."""
    rows: list[tuple[int, list[str]]] = []
    in_section = False
    for lineno, line in enumerate(doc_text.splitlines(), start=1):
        if line.startswith("## "):
            in_section = line.startswith(_CATALOG_HEADING)
            continue
        if not in_section or not line.lstrip().startswith("|"):
            continue
        cells = line.split("|")
        if len(cells) < 2:
            continue
        first = cells[1]
        if set(first.strip()) <= {"-", " ", ":"}:
            continue  # the header separator row
        tokens = [head + ("*" if tail else "")
                  for head, tail in _ROW_NAME.findall(first)]
        if tokens:
            rows.append((lineno, tokens))
    return rows


def lint_reverse_doc_drift(result: LintResult, doc_text: str,
                           doc_path: str, left_out=None) -> None:
    """The code->docs check's mirror: a metric-catalog row whose family
    is no longer registered ANYWHERE in the linted tree fails — a stale
    row sends the mid-incident reader hunting for a metric that no
    longer exists.  A token is vouched for by a literal registration
    (exact, or prefix-covered for wildcard rows — both `family.*` and
    `span.<name>`-style placeholder rows normalize to wildcards in
    catalog_rows) or by a dynamic registration whose constant fragment
    overlaps it (the doc token and the f-string prefix share a
    prefix).  A token in `left_out` (default `LEFT_OUT`) is not a gap; an
    entry of it that names no stale row is an error itself."""
    left_out = LEFT_OUT if left_out is None else left_out
    literals = {s.name for s in result.sites if not s.dynamic}
    fragments = [s.name for s in result.sites if s.dynamic and s.name]

    def covered(token: str) -> bool:
        if token.endswith("*"):
            prefix = token[:-1]
            return (any(name.startswith(prefix) for name in literals)
                    or any(f.startswith(prefix) or prefix.startswith(f)
                           for f in fragments))
        if token in literals:
            return True
        # `span.<name>`-style rows parse to their constant head ("span.");
        # match against dynamic sites' constant fragments either way round
        return any(f.startswith(token) or token.startswith(f)
                   for f in fragments)

    flagged: set[str] = set()
    excused: set[str] = set()
    for lineno, tokens in catalog_rows(doc_text):
        for token in tokens:
            if token in flagged or covered(token):
                continue
            if token in left_out:
                excused.add(token)
                continue
            flagged.add(token)
            result.errors.append(
                f"{doc_path}:{lineno}: catalog row names {token!r} but "
                f"no registration in the code matches it — prune the "
                f"row (or restore the metric)")
    for token in sorted(set(left_out) - excused):
        result.errors.append(
            f"{doc_path}: {token!r} is listed as left out of the port, "
            f"but no stale catalog row names it — drop it from LEFT_OUT")


def lint_tree(root: str, left_out=None) -> LintResult:
    """Lint `root`'s `cook_tpu_torch/` (or, lacking one, all of `root`)
    and, where `root` has it, its docs/observability.md catalog, with
    `left_out` (default `LEFT_OUT`) excused from the reverse check."""
    root_path = pathlib.Path(root)
    sites: list[CallSite] = []
    span_sites: list[SpanSite] = []
    scan_dirs = [d for d in (root_path / "cook_tpu_torch",) if d.is_dir()]
    if not scan_dirs:   # linting an arbitrary directory
        scan_dirs = [root_path]
    for scan in scan_dirs:
        for path in sorted(scan.rglob("*.py")):
            try:
                source = path.read_text()
            except OSError:
                continue
            sites.extend(collect_sites(source, str(path)))
            span_sites.extend(collect_span_sites(source, str(path)))
    result = lint_sites(sites, span_sites)
    doc = root_path / DOC_CATALOG
    if doc.is_file():
        try:
            doc_text = doc.read_text()
        except OSError:
            return result
        lint_doc_coverage(result, doc_text, str(doc))
        lint_reverse_doc_drift(result, doc_text, str(doc), left_out)
    return result


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else str(
        pathlib.Path(__file__).resolve().parent.parent.parent)
    result = lint_tree(root)
    for error in result.errors:
        print(f"lint_metrics: {error}", file=sys.stderr)
    literal = sum(1 for s in result.sites if not s.dynamic)
    print(f"lint_metrics: {len(result.sites)} metric call sites "
          f"({literal} literal), {len(result.span_sites)} span sites, "
          f"{len(result.errors)} errors")
    return 1 if result.errors else 0


if __name__ == "__main__":
    sys.exit(main())
