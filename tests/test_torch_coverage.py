"""The port covers the reference: a check of the two package trees, by
`ast` and file reads only (nothing of either package is imported).

`coverage_gaps(ref_root, port_root, chip_smoke)` lists, for each check,
every reference item without its port counterpart:

- (a) `modules`: every `*.py` under the reference has a counterpart at
  the same path under the port, but `ops/pallas_match.py`, whose Pallas
  kernels `csrc/*.cu` replaces (check (b) holds those);
- (b) `kernels`: every kernel entry of the reference (a function that
  reaches `pallas_call`, itself or through the module's helpers, and that
  no other such function calls) is the `replaces` of an entry in
  `chip_smoke.KERNELS`, as `<package>/<path>:<def line>`;
- (c) `cli`: every `--flag` and subcommand of every reference `argparse`
  parser exists in the counterpart module's parser, under the same
  subcommand;
- (d) `routes`: every (method, path) that a reference module registers
  (`add_get` / `add_post` / `add_put` / `add_delete` / `add_route`) its
  counterpart registers;
- (e) `names`: every top-level function and every method of a top-level
  class of a reference module is defined under the same name in the
  counterpart module, or is in `ALLOWED` with its reason.

- (f) `tools`: every script of the repository outside the package (at
  its top level, under `tools/` and under `examples/`) that imports
  `cook_tpu` or `jax` has a counterpart module under
  `cook_tpu_torch/tools/` or `cook_tpu_torch/examples/` (a top-level
  script under `cook_tpu_torch/tools/`), or a `TOOLS_ALLOWED` entry with
  its reason; each such pair, and each other script that has a
  counterpart, is held to checks (c) and (e): the same `argparse` flags,
  functions and methods.

`ALLOWED` is the list of what the port leaves out or names otherwise:
each entry is renamed (the port's name, which must exist), left out by
design (ROADMAP.md, "Deliberately not ported"), or aiohttp plumbing that
the standard-library server (`cook_tpu_torch/rest/http.py`) replaces.  An
entry that no longer names a gap is itself reported, so the list stays
exact."""
import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ROOT = os.path.join(REPO, "cook_tpu")
PORT_ROOT = os.path.join(REPO, "cook_tpu_torch")
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")

# reference modules with no counterpart file: their kernels are check (b)'s
REPLACED_MODULES = {"ops/pallas_match.py": "csrc/*.cu (check (b))"}

ROUTE_METHODS = {"add_get": "GET", "add_post": "POST", "add_put": "PUT",
                 "add_delete": "DELETE"}


def renamed(port_name):
    """The port carries the reference item under another name in the same
    module: a function, `Class.method`, dataclass field or module-level
    name, which must exist."""
    return ("renamed", port_name)


def unused(why):
    """The reference defines it and nothing of the reference reads it
    (its name occurs once in the whole package), so the port has nothing
    to carry."""
    return ("unused", why)


# ROADMAP.md "Deliberately not ported": a device solve that fails raises
# (the port never re-solves on the CPU, which would hide a fault of the
# card or a kernel), so the fallback ladder has no counterpart
FALLBACK = ("by design", "the device-fallback ladder (ROADMAP.md, "
            "Deliberately not ported)")
# ROADMAP.md "Deliberately not ported": XLA's cost analysis; the kernels'
# bounds come from their code (chip_smoke.py)
XLA_COST = ("by design", "XLA's cost analysis (ROADMAP.md, Deliberately "
            "not ported)")
# the reference serves on aiohttp; the port on the standard library's
# ThreadingHTTPServer (rest/server.py, rest/http.py), which needs no
# event-loop plumbing
AIOHTTP = ("aiohttp", "aiohttp plumbing; the standard-library server "
           "(rest/server.py, rest/http.py) replaces it")
# JAX pytrees: the port moves one tensor at a time (obs/data_plane.h2d)
PYTREES = ("by design", "JAX pytrees; the port places single tensors "
           "(obs/data_plane.h2d)")

# a knob that no code of the reference sets, kept as a constant
CONSTANT = ("by design", "a constant in the port: no caller of the "
            "reference sets it")

# "<module path>::<function | Class.method | Class.field>": its reason
ALLOWED = {
    # ---- renamed: the port's name for the same work
    "obs/profiling.py::_jax_start": renamed("_torch_start"),
    "obs/profiling.py::_jax_stop": renamed("_torch_stop"),
    # lax.cummax inside segmented_cumsum; the port's segment_first
    "ops/common.py::jax_cummax": renamed("segment_first"),
    # the jitted bodies of the update/gather programs, inline in the port
    "ops/device_update.py::_gather_rows": renamed("gather_rows"),
    "ops/device_update.py::_scatter_rows": renamed("scatter_rows"),
    # the greedy's scan body, inline in the port's loop
    "ops/match.py::_job_step": renamed("greedy_match_pools"),
    "ops/match.py::_segment_rank": renamed("_sorted_segments"),
    # `make -C native` there; the port's loader builds with one g++ call
    # (build.load_native)
    "ops/native.py::_build": renamed("_load"),
    # the sharded sync-ack wait, shared with single commits in the port
    "rest/api.py::CookApi._await_batch_replication":
        renamed("CookApi._await_replication_outcome"),
    # a module constant computed by a helper there, inline here
    "scheduler/matcher.py::_agent_removed_codes":
        renamed("AGENT_REMOVED_CODES"),
    # a check without a spend there; the port's callers check and spend
    # in one step
    "scheduler/ratelimit.py::TokenBucketRateLimiter.allowed":
        renamed("TokenBucketRateLimiter.try_spend"),
    "scheduler/ratelimit.py::UnlimitedRateLimiter.allowed":
        renamed("UnlimitedRateLimiter.try_spend"),
    # the simulator's H2D/D2H delta: the port sums the per-family totals
    "obs/data_plane.py::TransferLedger.byte_totals":
        renamed("TransferLedger.family_totals"),
    # ---- left out by design (ROADMAP.md, Queue A)
    "scheduler/matcher.py::CpuFallbackPending.__init__": FALLBACK,
    "scheduler/matcher.py::CpuFallbackPending.fetch": FALLBACK,
    "scheduler/matcher.py::_note_fallback_metrics": FALLBACK,
    "scheduler/matcher.py::check_device_fallback": FALLBACK,
    "scheduler/matcher.py::cpu_fallback_solve": FALLBACK,
    "scheduler/matcher.py::degrade_to_solve_failed": FALLBACK,
    "scheduler/matcher.py::enter_device_fallback": FALLBACK,
    "scheduler/matcher.py::exit_device_fallback": FALLBACK,
    "scheduler/matcher.py::record_fallback_outcome": FALLBACK,
    "scheduler/matcher.py::MatchConfig.device_fallback_cycles": FALLBACK,
    "scheduler/matcher.py::MatchConfig.device_latency_guard": FALLBACK,
    "scheduler/matcher.py::PoolMatchState.fallback_cycles_left": FALLBACK,
    "scheduler/matcher.py::PoolMatchState.fallback_reason": FALLBACK,
    "scheduler/pipeline.py::_Stage.fallback_reason": FALLBACK,
    "obs/compile_observatory.py::CompileObservatory.cost": XLA_COST,
    "obs/compile_observatory.py::CompileObservatory.cost_stats": XLA_COST,
    "obs/compile_observatory.py::CompileObservatory.observe_cost":
        XLA_COST,
    "obs/data_plane.py::cost_analysis": XLA_COST,
    "obs/data_plane.py::probe_roofline": XLA_COST,
    "scheduler/matcher.py::_maybe_probe_roofline": XLA_COST,
    "obs/data_plane.py::device_put": PYTREES,
    "obs/data_plane.py::tree_nbytes": PYTREES,
    # the pipelined pass always drains its launches, within its constant
    # DRAIN_TIMEOUT_S: both packages' Scheduler build PipelineParams from
    # `pipeline_depth` and `async_launch` alone, so nothing sets these
    "scheduler/pipeline.py::PipelineParams.drain_launches": CONSTANT,
    "scheduler/pipeline.py::PipelineParams.drain_timeout_s": CONSTANT,
    # the compile observatory's storm window, threshold and warmup are
    # DeviceTelemetry's defaults, and the OOM threshold is
    # obs/health.OOM_THRESHOLD: no caller of the reference sets these
    "scheduler/core.py::SchedulerConfig.compile_storm_window": CONSTANT,
    "scheduler/core.py::SchedulerConfig.compile_storm_threshold": CONSTANT,
    "scheduler/core.py::SchedulerConfig.compile_storm_warmup": CONSTANT,
    "scheduler/core.py::SchedulerConfig.device_oom_threshold": CONSTANT,
    # the reference's package-level lazy exports (PEP 562); every import
    # of the port's obs package names the submodule
    "obs/__init__.py::__getattr__": (
        "by design", "no lazy export table: the port imports obs/<module> "
        "directly"),
    "obs/__init__.py::__dir__": (
        "by design", "no lazy export table: the port imports obs/<module> "
        "directly"),
    # the port's REST layer calls only try_spend on the unlimited limiter
    "scheduler/ratelimit.py::UnlimitedRateLimiter.spend": (
        "by design", "the port's callers of the unlimited limiter call "
        "try_spend alone"),
    # a test hook there; the port's tests build a fresh TransferLedger
    "obs/data_plane.py::TransferLedger.reset": (
        "by design", "a test hook; the port's tests build a fresh "
        "TransferLedger"),
    # ---- aiohttp plumbing
    "mp/router.py::FrontEnd._ensure_session": AIOHTTP,
    "rest/api.py::CookApi._ensure_repl_watcher": AIOHTTP,
    "rest/api.py::run_server": AIOHTTP,
    # ---- read nowhere in the reference
    "scheduler/core.py::SchedulerConfig.max_runtime_check":
        unused("a flag no code of cook_tpu/ reads"),
    "scheduler/flight_recorder.py::FlightRecorder.note_job_reason":
        unused("a method no code of cook_tpu/ calls"),
}

REPO_ROOT = REPO
PORT_TOOLS = os.path.join(PORT_ROOT, "tools")


def pending(why):
    """Ported by a later piece of work, named in ROADMAP.md."""
    return ("pending", why)


# the scripts outside the package, as "<path from the repo root>" (a
# script without its counterpart) or "<path>::<name>" (a function or
# method of a paired script): its reason
TOOLS_ALLOWED = {
    "bench.py": pending(
        "the reference's benchmark harness; the port's benchmark is "
        "ROADMAP.md N1"),
    "__graft_entry__.py": (
        "by design", "JAX compile-check entry points for TPU runs (one "
        "chip's compile check, the multi-chip dry run); the port's check "
        "on the card is chip_smoke.py"),
    # the port runs on the card, not a TPU
    "tools/tpu_sweep.py": renamed("tools/match_sweep.py"),
    # by design: the port has no device-fallback ladder (ROADMAP.md,
    # Deliberately not ported), so its scenario holds the port's own
    # reaction to a failed solve instead of a CPU re-solve
    "tools/chaos.py::scenario_device_fallback":
        renamed("scenario_device_error"),
    # a class, whose close() closes every thread's session after the run
    "tools/loadtest.py::_thread_sessions":
        renamed("_ThreadSessions.__call__"),
}


# ------------------------------------------------------------ the checker


def _modules(root):
    """Relative paths of every .py file under root."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           root).replace(os.sep, "/"))
    return out


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _defs(tree):
    """{name: FunctionDef} of the module's top-level functions and
    {"Class.method": FunctionDef} of its top-level classes' methods."""
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for node in tree.body:
        if isinstance(node, funcs):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, funcs):
                    out[f"{node.name}.{item.name}"] = item
    return out


def _fields(tree):
    """{"Class.field"} of the module's top-level dataclasses."""
    out = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and any(
                "dataclass" in ast.dump(d) for d in node.decorator_list):
            out.update(f"{node.name}.{item.target.id}" for item in node.body
                       if isinstance(item, ast.AnnAssign)
                       and isinstance(item.target, ast.Name))
    return out


def _assigned(tree):
    """Names the module assigns at its top level."""
    return {t.id for node in tree.body if isinstance(node, ast.Assign)
            for t in node.targets if isinstance(t, ast.Name)}


def _constants(tree):
    """Module-level NAME = <literal> assignments, evaluated."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = _value(node.value, out, {})
            except ValueError:
                pass
    return out


def _value(node, consts, bound):
    """The value of a literal expression: constants, tuples, lists, sets,
    dicts, names bound by an unrolled loop or a module constant, and
    sorted / set / frozenset / tuple / list of those.  ValueError
    otherwise."""
    if isinstance(node, ast.Name):
        for scope in (bound, consts):
            if node.id in scope:
                return scope[node.id]
        raise ValueError(node.id)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("sorted", "set", "frozenset", "tuple",
                                 "list") \
            and len(node.args) == 1 and not node.keywords:
        inner = _value(node.args[0], consts, bound)
        return sorted(inner) if node.func.id == "sorted" else \
            {"set": set, "frozenset": frozenset, "tuple": tuple,
             "list": list}[node.func.id](inner)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        items = [_item(e, consts, bound) for e in node.elts]
        return tuple(items) if isinstance(node, ast.Tuple) else (
            set(items) if isinstance(node, ast.Set) else items)
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Dict):
        return {_value(k, consts, bound): _value(v, consts, bound)
                for k, v in zip(node.keys, node.values)}
    raise ValueError(ast.dump(node))


def _item(node, consts, bound):
    """An element of a literal collection: its value, or UNKNOWN (a loop
    over `(name, handler)` pairs still binds `name`)."""
    try:
        return _value(node, consts, bound)
    except ValueError:
        return UNKNOWN


UNKNOWN = object()


def _bind(target, value, bound):
    if isinstance(target, ast.Name):
        bound[target.id] = value
    elif isinstance(target, (ast.Tuple, ast.List)):
        for t, v in zip(target.elts, value):
            _bind(t, v, bound)


class _Surface:
    """A module's command-line and HTTP surface, from an abstract run of
    each scope's statements in order: loops over literals are unrolled,
    an `if` on bound names takes its branch.  `flags` holds (subcommand
    path, option string), `commands` subcommand paths, `routes` (method,
    path)."""

    def __init__(self, tree):
        self.consts = _constants(tree)
        self.flags, self.commands, self.routes = set(), set(), set()
        self._run(tree.body, {}, {})
        for node in _defs(tree).values():
            self._run(node.body, {}, {})

    def _strings(self, node, bound):
        try:
            value = _value(node, self.consts, bound)
        except (ValueError, TypeError):
            return []
        return [value] if isinstance(value, str) else []

    def _call(self, call, parsers, bound, target=None):
        func = call.func
        if isinstance(func, ast.Name) and func.id == "ArgumentParser" or \
                isinstance(func, ast.Attribute) \
                and func.attr == "ArgumentParser":
            if target:
                parsers[target] = [()]
            return
        if not isinstance(func, ast.Attribute):
            return
        owner = (parsers.get(func.value.id, [()])
                 if isinstance(func.value, ast.Name) else [()])
        if func.attr == "add_subparsers" and target:
            parsers[target] = owner
        elif func.attr == "add_parser" and call.args:
            paths = [p + (name,) for p in owner
                     for name in self._strings(call.args[0], bound)]
            self.commands.update(paths)
            if target:
                parsers[target] = paths
        elif func.attr == "add_argument":
            for arg in call.args:
                for s in self._strings(arg, bound):
                    if s.startswith("-"):
                        self.flags.update((p, s) for p in owner)
        elif func.attr in ROUTE_METHODS and call.args:
            for path in self._strings(call.args[0], bound):
                self.routes.add((ROUTE_METHODS[func.attr], path))
        elif func.attr == "add_route" and len(call.args) >= 2:
            for method in self._strings(call.args[0], bound):
                for path in self._strings(call.args[1], bound):
                    self.routes.add((method, path))

    def _calls(self, node, parsers, bound):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub, parsers, bound)

    def _test(self, test, bound):
        """True / False for an `if` on bound names and literals, else
        None (both branches run)."""
        try:
            names = {n.id for n in ast.walk(test)
                     if isinstance(n, ast.Name)}
            if not names or not names <= set(bound):
                return None
            return bool(eval(compile(ast.Expression(test), "<if>", "eval"),
                             {"__builtins__": {}}, dict(bound)))
        except Exception:  # noqa: BLE001 — not a static test
            return None

    def _run(self, body, parsers, bound):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # its own scope (_defs), or not a parser's
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call) \
                    and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                self._calls(stmt.value, parsers, bound)
                self._call(stmt.value, parsers, bound,
                           target=stmt.targets[0].id)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                try:
                    items = list(_value(stmt.iter, self.consts, bound))
                except (ValueError, TypeError):
                    items = None
                if items is None:
                    self._run(stmt.body, parsers, bound)
                for item in items or ():
                    inner = dict(bound)
                    _bind(stmt.target, item, inner)
                    self._run(stmt.body, parsers, inner)
                self._run(stmt.orelse, parsers, bound)
            elif isinstance(stmt, ast.If):
                taken = self._test(stmt.test, bound)
                if taken is not False:
                    self._run(stmt.body, parsers, bound)
                if taken is not True:
                    self._run(stmt.orelse, parsers, bound)
            elif isinstance(stmt, (ast.With, ast.AsyncWith, ast.While)):
                self._run(stmt.body, parsers, bound)
            elif isinstance(stmt, ast.Try):
                for block in (stmt.body, *(h.body for h in stmt.handlers),
                              stmt.orelse, stmt.finalbody):
                    self._run(block, parsers, bound)
            else:
                self._calls(stmt, parsers, bound)


def _kernel_entries(tree):
    """{name: def line} of the module's functions that reach
    `pallas_call` and that no other such function calls."""
    defs = {name: node for name, node in _defs(tree).items()
            if "." not in name}
    calls, direct = {}, set()
    for name, node in defs.items():
        calls[name] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and sub.attr == "pallas_call" \
                    or isinstance(sub, ast.Name) and sub.id == "pallas_call":
                direct.add(name)
            if isinstance(sub, ast.Name) and sub.id in defs \
                    and sub.id != name:
                calls[name].add(sub.id)
    reach = set(direct)
    while True:
        more = {n for n, callees in calls.items() if callees & reach}
        if more <= reach:
            break
        reach |= more
    called = {c for n in reach for c in calls[n]}
    return {n: defs[n].lineno for n in sorted(reach - called)}


def _chip_smoke_replaces(path):
    """Every string of `KERNELS`' values in chip_smoke.py."""
    for node in _parse(path).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "KERNELS"
                for t in node.targets):
            return {s.value for v in node.value.values
                    for s in ast.walk(v)
                    if isinstance(s, ast.Constant)
                    and isinstance(s.value, str)}
    return set()


def _module_gaps(rel, ref_tree, port_tree, allowed, gaps, missing):
    """Checks (c)-(e) and `fields` of one module pair, `rel` naming the
    reference module in gaps and allowlist keys: each gap appended to
    `gaps[check]`, each missing name's key added to `missing`."""
    ref_s, port_s = _Surface(ref_tree), _Surface(port_tree)
    for path in sorted(ref_s.commands - port_s.commands):
        gaps["cli"].append(f"{rel}: subcommand {' '.join(path)}")
    for path, flag in sorted(ref_s.flags - port_s.flags):
        where = " ".join(path) or "(top level)"
        gaps["cli"].append(f"{rel}: {where} {flag}")
    for method, path in sorted(ref_s.routes - port_s.routes):
        gaps["routes"].append(f"{rel}: {method} {path}")
    port_names = set(_defs(port_tree)) | _fields(port_tree) \
        | _assigned(port_tree)
    for check, names in (("names", set(_defs(ref_tree))),
                         ("fields", _fields(ref_tree))):
        for name in sorted(names - port_names):
            key = f"{rel}::{name}"
            missing.add(key)
            if key not in allowed:
                gaps[check].append(f"{key}: no counterpart")
    for key, (kind, why) in allowed.items():
        if key.startswith(f"{rel}::") and kind == "renamed" \
                and why not in port_names:
            gaps["allowlist"].append(
                f"{key}: renamed to {why}, which {rel} lacks")


def coverage_gaps(ref_root, port_root, chip_smoke, allowed=None):
    """{check: [gap, ...]}: `modules`, `kernels`, `cli`, `routes`, `names`
    (the module docstring's (a)-(e)) and `fields` (every field of a
    reference dataclass in the counterpart class, allowed as names are),
    each gap a line naming the reference item; and `allowlist`: entries of
    `allowed` that name no gap, a renamed target the port lacks, or an
    `unused` item that the reference reads after all."""
    allowed = ALLOWED if allowed is None else allowed
    package = os.path.basename(os.path.normpath(ref_root))
    gaps = {k: [] for k in ("modules", "kernels", "cli", "routes", "names",
                            "fields", "allowlist")}
    replaces = _chip_smoke_replaces(chip_smoke)
    sources, missing = {}, set()
    for rel in _modules(ref_root):
        with open(os.path.join(ref_root, rel)) as f:
            sources[rel] = f.read()
        ref_tree = ast.parse(sources[rel], filename=rel)
        if "pallas_call" in sources[rel]:
            for name, line in _kernel_entries(ref_tree).items():
                if f"{package}/{rel}:{line}" not in replaces:
                    gaps["kernels"].append(
                        f"{package}/{rel}:{line} {name}: no entry of "
                        f"chip_smoke.KERNELS replaces it")
        port_path = os.path.join(port_root, rel)
        if not os.path.exists(port_path):
            if rel not in REPLACED_MODULES:
                gaps["modules"].append(f"{rel}: no counterpart module")
            continue
        _module_gaps(rel, ref_tree, _parse(port_path), allowed, gaps,
                     missing)
    for key, (kind, _) in sorted(allowed.items()):
        if key not in missing:
            gaps["allowlist"].append(f"{key}: allowed, but not a gap")
        elif kind == "unused":
            name = key.rpartition(".")[2].rpartition(":")[2]
            uses = sum(len(re.findall(rf"\b{name}\b", text))
                       for text in sources.values())
            if uses != 1:
                gaps["allowlist"].append(
                    f"{key}: allowed as unused, but {package}/ names it "
                    f"{uses} times")
    return gaps


def _imports_reference(tree):
    """True when the script imports `cook_tpu` or `jax` anywhere (its top
    level or inside a function)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.partition(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            roots = [node.module.partition(".")[0]]
        else:
            continue
        if {"cook_tpu", "jax"} & set(roots):
            return True
    return False


def _scripts(repo_root):
    """Paths, from the repo root, of its top-level scripts and of every
    `*.py` directly under `tools/` and `examples/`."""
    out = []
    for sub in ("", "tools", "examples"):
        directory = os.path.join(repo_root, sub)
        if os.path.isdir(directory):
            out += [os.path.join(sub, name).replace(os.sep, "/")
                    for name in sorted(os.listdir(directory))
                    if name.endswith(".py")]
    return out


def _script_counterpart(rel):
    """The port path (from the port root) that answers script `rel`."""
    sub, _, name = rel.rpartition("/")
    return f"{sub or 'tools'}/{name}"


def tool_gaps(repo_root, port_root, allowed=None):
    """{check: [gap, ...]} for check (f): `modules` (a script that imports
    `cook_tpu` or `jax` without a counterpart or an entry), `cli`,
    `routes`, `names` and `fields` of each pair, and `allowlist`, as in
    `coverage_gaps`."""
    allowed = TOOLS_ALLOWED if allowed is None else allowed
    gaps = {k: [] for k in ("modules", "cli", "routes", "names", "fields",
                            "allowlist")}
    missing = set()
    for rel in _scripts(repo_root):
        ref_tree = _parse(os.path.join(repo_root, rel))
        kind, target = allowed.get(rel, (None, None))
        port_rel = (target if kind == "renamed"
                    else _script_counterpart(rel))
        port_path = os.path.join(port_root, port_rel)
        if not os.path.exists(port_path):
            if kind == "renamed":
                gaps["allowlist"].append(
                    f"{rel}: renamed to {target}, which "
                    f"{os.path.basename(port_root)}/ lacks")
            if _imports_reference(ref_tree):
                missing.add(rel)
                if rel not in allowed:
                    gaps["modules"].append(
                        f"{rel}: imports cook_tpu or jax, no counterpart "
                        f"{os.path.basename(port_root)}/{port_rel}")
            continue
        if kind == "renamed":
            missing.add(rel)
        _module_gaps(rel, ref_tree, _parse(port_path), allowed, gaps,
                     missing)
    for key in sorted(allowed):
        if key not in missing:
            gaps["allowlist"].append(f"{key}: allowed, but not a gap")
    return gaps


# ------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def gaps():
    return coverage_gaps(REF_ROOT, PORT_ROOT, CHIP_SMOKE)


def _report(gaps, check):
    return f"{len(gaps[check])} gap(s):\n" + "\n".join(gaps[check])


def test_every_reference_module_has_a_counterpart(gaps):
    """(a): every `cook_tpu/**/*.py` but `ops/pallas_match.py`."""
    assert gaps["modules"] == [], _report(gaps, "modules")
    assert sorted(REPLACED_MODULES) == ["ops/pallas_match.py"]


def test_every_pallas_kernel_is_a_chip_smoke_kernel(gaps):
    """(b): the kernel entries of `cook_tpu/ops/pallas_match.py` are
    `best_node`, `best_block` and `best_node_batched` (the scaffold
    `_grid_best_call` is reached only through the first two), and each is
    the `replaces` of an entry of `chip_smoke.KERNELS`."""
    assert gaps["kernels"] == [], _report(gaps, "kernels")
    tree = _parse(os.path.join(REF_ROOT, "ops", "pallas_match.py"))
    entries = _kernel_entries(tree)
    assert sorted(entries) == ["best_block", "best_node",
                               "best_node_batched"]
    assert {f"cook_tpu/ops/pallas_match.py:{line}"
            for line in entries.values()} <= _chip_smoke_replaces(CHIP_SMOKE)


def test_every_reference_flag_and_subcommand_is_the_ports(gaps):
    """(c): every parser of the reference (the service, `cs`, the
    simulator, the lease server, the mp worker, the sidecar); the
    simulator's `run` has the four dump flags."""
    assert gaps["cli"] == [], _report(gaps, "cli")
    sim = _Surface(_parse(os.path.join(PORT_ROOT, "sim", "cli.py")))
    for flag in ("--health-out", "--cycles-out", "--trace-out",
                 "--incidents-out"):
        assert (("run",), flag) in sim.flags
    # the extraction sees loops, nested subparsers and the top level
    cs = _Surface(_parse(os.path.join(REF_ROOT, "client", "cli.py")))
    assert {("show",), ("kill",), ("admin", "set-share")} <= cs.commands
    assert {(("show",), "--json"), (("admin", "set-quota"), "--count"),
            ((), "--route-map")} <= cs.flags
    assert (("wait",), "--json") not in cs.flags


def test_every_reference_route_is_the_ports(gaps):
    """(d): the routes of `rest/api.py`, the mp front end's and worker's
    and the sidecar's."""
    assert gaps["routes"] == [], _report(gaps, "routes")
    api = _Surface(_parse(os.path.join(REF_ROOT, "rest", "api.py")))
    assert {("GET", "/rawscheduler"), ("DELETE", "/jobs"),
            ("PUT", "/retry"), ("GET", "/debug/incidents/{incident_id}"),
            } <= api.routes
    router = _Surface(_parse(os.path.join(REF_ROOT, "mp", "router.py")))
    assert ("*", "/{tail:.*}") in router.routes
    assert len({p for m, p in router.routes if m == "GET"}) > 20


def test_every_reference_function_method_and_field_is_the_ports(gaps):
    """(e): every top-level function and method, and every dataclass
    field, has a same-named counterpart or an `ALLOWED` entry with its
    reason; every entry names a gap, a renamed entry a name the port has,
    and an `unused` entry a name read nowhere in the reference."""
    assert gaps["names"] == [], _report(gaps, "names")
    assert gaps["fields"] == [], _report(gaps, "fields")
    assert gaps["allowlist"] == [], _report(gaps, "allowlist")
    kinds = {kind for kind, _ in ALLOWED.values()}
    assert kinds <= {"renamed", "by design", "aiohttp", "unused"}
    assert all(why for _, why in ALLOWED.values())


SYNTH_REF = {
    "kept.py": "def f():\n    pass\n\n\ndef g():\n    pass\n\n\n"
               "class C:\n    def m(self):\n        pass\n",
    "gone.py": "X = 1\n",
    "cli.py": (
        "import argparse\n\n\ndef main():\n"
        "    p = argparse.ArgumentParser()\n"
        "    p.add_argument('--top')\n"
        "    sub = p.add_subparsers()\n"
        "    for name in ('run', 'walk'):\n"
        "        r = sub.add_parser(name)\n"
        "        if name == 'run':\n"
        "            r.add_argument('--fast')\n"
        "        r.add_argument('--out')\n"),
    "api.py": (
        "ROUTES = ('/a', '/b')\n\n\nclass Api:\n"
        "    def build(self, r):\n"
        "        for path in sorted(ROUTES):\n"
        "            r.add_get(path, self.build)\n"
        "        r.add_post('/c', self.build)\n"),
    "ops/pallas_match.py": (
        "def _scaffold():\n    return pl.pallas_call(None)\n\n\n"
        "def kernel():\n    return _scaffold()\n\n\n"
        "def other():\n    return pl.pallas_call(None)\n"),
}
SYNTH_PORT = {
    "kept.py": "class C:\n    def m2(self):\n        pass\n",
    "cli.py": (
        "import argparse\n\n\ndef main():\n"
        "    p = argparse.ArgumentParser()\n"
        "    p.add_argument('--top')\n"
        "    sub = p.add_subparsers()\n"
        "    q = sub.add_parser('run')\n"
        "    q.add_argument('--out')\n"
        "    q = sub.add_parser('walk')\n"
        "    q.add_argument('--out')\n"),
    "api.py": ("class Api:\n    def build(self, r):\n"
               "        r.add_get('/a', self.build)\n"
               "        r.add_post('/c', self.build)\n"),
}


def _write_tree(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def test_the_checker_names_every_gap_of_a_synthetic_pair(tmp_path):
    """A tiny reference and port: the checker names, all at once, the
    missing module, the `run --fast` flag, the GET /b route (from a loop
    over a sorted module constant), the function `f`, the kernel entry
    `other` that no KERNELS entry replaces (`kernel` is listed, and the
    scaffold is reached through it), a renamed target the port lacks
    (`g`) and a stale allowlist entry; `C.m`, renamed to `C.m2`, is no
    gap.  With all of those added to the port, nothing."""
    ref, port = tmp_path / "refpkg", tmp_path / "port"
    _write_tree(ref, SYNTH_REF)
    _write_tree(port, SYNTH_PORT)
    smoke = tmp_path / "chip_smoke.py"
    smoke.write_text('KERNELS = {"kernel": ("m", "s.cu", '
                     '"refpkg/ops/pallas_match.py:5")}\n')
    allowed = {"kept.py::C.m": renamed("C.m2"),
               "kept.py::g": renamed("g2"),
               "cli.py::gone": ("by design", "why")}
    gaps = coverage_gaps(str(ref), str(port), str(smoke), allowed)
    assert gaps == {
        "modules": ["gone.py: no counterpart module"],
        "kernels": ["refpkg/ops/pallas_match.py:9 other: no entry of "
                    "chip_smoke.KERNELS replaces it"],
        "cli": ["cli.py: run --fast"],
        "routes": ["api.py: GET /b"],
        "names": ["kept.py::f: no counterpart"],
        "fields": [],
        "allowlist": ["kept.py::g: renamed to g2, which kept.py lacks",
                      "cli.py::gone: allowed, but not a gap"],
    }
    _write_tree(port, {
        "gone.py": "X = 1\n",
        "kept.py": SYNTH_PORT["kept.py"] + "    def m(self):\n        pass\n"
        "\n\ndef f():\n    pass\n\n\ndef g():\n    pass\n",
        "cli.py": SYNTH_PORT["cli.py"] + "    p.add_argument('--fast')\n",
        "api.py": SYNTH_PORT["api.py"]
        + "        r.add_get('/b', self.build)\n"})
    # '--fast' on the top-level parser is not `run --fast`
    assert coverage_gaps(str(ref), str(port), str(smoke), {})["cli"] == [
        "cli.py: run --fast"]
    _write_tree(port, {"cli.py": SYNTH_PORT["cli.py"].replace(
        "    q = sub.add_parser('walk')", "    q.add_argument('--fast')\n"
        "    q = sub.add_parser('walk')")})
    smoke.write_text('KERNELS = {"kernel": ("m", "s.cu", '
                     '"refpkg/ops/pallas_match.py:5"), "other": '
                     '("m", "o.cu", "refpkg/ops/pallas_match.py:9")}\n')
    assert coverage_gaps(str(ref), str(port), str(smoke), {}) == {
        k: [] for k in gaps}


@pytest.fixture(scope="module")
def script_gaps():
    return tool_gaps(REPO_ROOT, PORT_ROOT)


def test_every_reference_script_has_a_counterpart(script_gaps):
    """(f): every script outside the package that imports `cook_tpu` or
    `jax` has its counterpart under `cook_tpu_torch/tools/` or
    `cook_tpu_torch/examples/` (or a `TOOLS_ALLOWED` entry), with the same
    flags, functions and methods; the standard-library lint and CI
    pipeline, which have counterparts, are held to them too."""
    for check in ("modules", "cli", "routes", "names", "fields",
                  "allowlist"):
        assert script_gaps[check] == [], _report(script_gaps, check)
    required = {rel for rel in _scripts(REPO_ROOT) if _imports_reference(
        _parse(os.path.join(REPO_ROOT, rel)))}
    assert required == {
        "__graft_entry__.py", "bench.py", "tools/chaos.py",
        "tools/debug_smoke.py", "tools/loadtest.py",
        "tools/migrate_journal.py", "tools/tpu_sweep.py",
        "examples/multihost_dryrun.py"}
    for rel in ("tools/chaos.py", "tools/debug_smoke.py",
                "tools/loadtest.py", "tools/migrate_journal.py",
                "tools/lint_metrics.py", "tools/ci_checks.py",
                "examples/multihost_dryrun.py"):
        assert os.path.exists(os.path.join(PORT_ROOT,
                                           _script_counterpart(rel))), rel
    sweep = _Surface(_parse(os.path.join(PORT_TOOLS, "match_sweep.py")))
    assert {((), "--backend"), ((), "--pallas"), ((), "--limit"),
            ((), "--device")} <= sweep.flags
    kinds = {kind for kind, _ in TOOLS_ALLOWED.values()}
    assert kinds <= {"renamed", "by design", "pending"}
    assert all(why for _, why in TOOLS_ALLOWED.values())


SYNTH_SCRIPTS = {
    "bench.py": "import jax\n",
    "plain.py": "import json\n",
    "tools/drill.py": (
        "import argparse\n\n\ndef scenario():\n"
        "    from cook_tpu import faults\n\n\ndef main():\n"
        "    p = argparse.ArgumentParser()\n"
        "    p.add_argument('--smoke')\n    p.add_argument('--json')\n"),
    "tools/sweep.py": "import argparse\nimport jax\n\n\ndef main():\n"
                      "    argparse.ArgumentParser().add_argument('--out')\n",
    "tools/gate.py": "import json\n\n\ndef main():\n    pass\n",
    "examples/dry.py": "from jax.sharding import Mesh\n\n\ndef worker():\n"
                       "    pass\n",
}


def test_the_checker_names_every_gap_of_a_synthetic_tool_pair(tmp_path):
    """A tiny repository and port: the checker names, at once, a script
    importing `jax` with no counterpart (`examples/dry.py`), a flag its
    pair lacks (`--json`), a function its pair lacks (`scenario`), a
    renamed script whose target is missing, and a stale entry; a script
    importing neither (`plain.py`, `tools/gate.py`) needs nothing.  With
    the counterparts added, nothing."""
    repo, port = tmp_path / "repo", tmp_path / "port"
    _write_tree(repo, SYNTH_SCRIPTS)
    _write_tree(port, {
        "tools/drill.py": "import argparse\n\n\ndef main():\n"
                          "    p = argparse.ArgumentParser()\n"
                          "    p.add_argument('--smoke')\n"})
    allowed = {"bench.py": pending("a later benchmark"),
               "tools/sweep.py": renamed("tools/knob_sweep.py"),
               "plain.py": ("by design", "why")}
    gaps = tool_gaps(str(repo), str(port), allowed)
    assert gaps == {
        "modules": ["examples/dry.py: imports cook_tpu or jax, no "
                    "counterpart port/examples/dry.py"],
        "cli": ["tools/drill.py: (top level) --json"],
        "routes": [],
        "names": ["tools/drill.py::scenario: no counterpart"],
        "fields": [],
        "allowlist": ["tools/sweep.py: renamed to tools/knob_sweep.py, "
                      "which port/ lacks",
                      "plain.py: allowed, but not a gap"],
    }
    _write_tree(port, {
        "tools/drill.py": SYNTH_SCRIPTS["tools/drill.py"],
        "tools/knob_sweep.py": SYNTH_SCRIPTS["tools/sweep.py"],
        "examples/dry.py": "def worker():\n    pass\n"})
    del allowed["plain.py"]
    assert tool_gaps(str(repo), str(port), allowed) == {
        k: [] for k in gaps}
    # the renamed script's pair is held to its flags too
    _write_tree(port, {"tools/knob_sweep.py": "def main():\n    pass\n"})
    assert tool_gaps(str(repo), str(port), allowed)["cli"] == [
        "tools/sweep.py: (top level) --out"]
