"""AST invariant checkers (photon-lint) over ``photon_ml_torch``.

Counterpart of ``photon_ml_tpu/analysis/checkers.py``.  Each rule
encodes a performance/correctness contract of threaded, streamed or
multi-host code that a later change could silently regress:

- ``unlocked-shared-write``: classes that spawn ``threading.Thread`` /
  ``ThreadPoolExecutor`` (or that own a lock) must mutate shared
  attributes under their lock or communicate via ``queue.Queue`` /
  ``threading.Event``.  Flags writes reachable from both the worker
  and the caller that are not lexically under a ``with self.<lock>:``.
- ``accumulator-dtype``: streaming metric/loss accumulators (classes
  with the ``update``/``result`` protocol) must fold on the host in
  float64 -- an augmented assignment into a ``self`` attribute must not
  run through a ``torch.*`` call (a device fold) or a float32 cast
  (``torch.float32``, ``np.float32``, ``"float32"``, ``.float()``).
- ``env-read``: no raw ``os.environ`` / ``os.getenv`` reads outside
  ``config.py``'s sanctioned registry (``config.read_env``) -- scatter
  env fallbacks are invisible configuration.
- ``naked-clock``: no ``time.time()`` in duration arithmetic.
- ``metric-name``: telemetry metrics are dotted lowercase names.
- ``swallowed-exception``: an ``except`` whose body only
  passes/continues/breaks/bare-returns -- the failure is silently
  discarded (fault tolerance is only honest when every absorbed failure
  is reported, handled with a real fallback, or waived with a reason).
- ``eternal-wait``: in a thread-spawning class, a blocking wait with
  no timeout -- ``queue.get()``, ``Event.wait()``, ``Thread.join()``,
  ``socket.recv()`` -- can pin a thread forever when its peer dies.
  Every cross-thread wait must be bounded, or waived with the reason
  the block is provably terminated (e.g. a close() sentinel).
- ``collective-in-host-branch``: a collective (``torch.distributed``'s
  ``all_reduce``/``all_gather``/``reduce_scatter``/``broadcast``/
  ``barrier``, the mesh's ``all_reduce_sum``/``all_reduce_max``, the
  fleet reducer's per-step ``reduce``) inside a branch on the process
  identity (``get_rank()``, ``process_index``, ``host_id``) deadlocks
  the hosts that skip it.
- ``slow-unmarked``: tests whose recorded tier-1 duration exceeds the
  threshold must carry ``@pytest.mark.slow`` (durations recorded once
  in ``tests/tier1_durations.json``).

Not ported (``NOT_PORTED``): ``jit-in-function``, ``tracer-hygiene``
and ``while-loop-carry-dtype``.  Eager PyTorch builds no jit
executables, has no tracers and no ``lax.while_loop`` carry, so the
code these rules read does not exist here; the host synchronizations
``tracer-hygiene`` guarded against are counted at run time by
``analysis.guards.no_implicit_transfers`` instead.  The same reason
leaves the reference's ``tracer_leak_guard`` out.

Waivers: a violation line may carry an inline waiver comment

    # photon-lint: disable=<rule>[,<rule>] (<reason>)

The reason is mandatory -- a waiver without one is ignored (and
reported), so every suppression documents why the contract does not
apply at that site.  A waiver on a comment-only line covers the next
code line; one quoted inside a string does nothing.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize

# Test duration above which a test must be @pytest.mark.slow (seconds).
SLOW_THRESHOLD_S = 10.0

# Recorded tier-1 durations (max over parametrizations, seconds),
# measured once per re-baseline -- see tests/tier1_durations.json.
DURATIONS_FILE = os.path.join("tests", "tier1_durations.json")

# The package the repo-wide run walks.
PACKAGE = "photon_ml_torch"

RULES = {
    "unlocked-shared-write": (
        "shared mutable attribute written without the owning lock in a "
        "thread-spawning class"
    ),
    "accumulator-dtype": (
        "streaming accumulator folds through a torch call/float32 "
        "instead of host float64"
    ),
    "env-read": (
        "raw os.environ read outside config.py's sanctioned registry "
        "(use photon_ml_torch.config.read_env)"
    ),
    "naked-clock": (
        "time.time() used in duration arithmetic; wall clock steps "
        "under NTP/suspend — use time.monotonic()/time.perf_counter()"
    ),
    "metric-name": (
        "telemetry counter/gauge/histogram registered under a name "
        "that is not a dotted lowercase identifier (namespace.metric)"
    ),
    "swallowed-exception": (
        "except handler silently discards the failure (pass/continue/"
        "break/bare return) without re-raising or logging — waiver "
        "with reason for deliberate best-effort sites"
    ),
    "eternal-wait": (
        "unbounded blocking wait (queue.get()/Event.wait()/"
        "Thread.join()/socket.recv() with no timeout) in a "
        "thread-spawning class — a dead peer pins the thread forever; "
        "bound it or waive with the termination argument"
    ),
    "collective-in-host-branch": (
        "all_reduce/all_gather/... lexically inside a branch "
        "conditioned on the process identity (get_rank()/"
        "process_index/host_id) — processes that skip the branch never "
        "reach the collective and the fleet deadlocks at the barrier"
    ),
    "slow-unmarked": (
        "test measured slower than the threshold lacks "
        "@pytest.mark.slow"
    ),
    "bad-waiver": (
        "photon-lint waiver without a (reason) — every suppression "
        "must say why the contract does not apply"
    ),
    "syntax-error": "file failed to parse",
}

# The reference's rules with no counterpart here, and why.
NOT_PORTED = {
    "jit-in-function": (
        "eager PyTorch builds no jit executables, so there is no "
        "per-call recompile to guard against"),
    "tracer-hygiene": (
        "eager PyTorch has no tracers; host synchronizations are "
        "counted at run time by analysis.guards.no_implicit_transfers"),
    "while-loop-carry-dtype": (
        "eager PyTorch has no lax.while_loop carry"),
}

_WAIVER_RE = re.compile(
    r"#\s*photon-lint:\s*disable=([\w,-]+)\s*(?:\((.*?)\))?")


def _comments(source: str):
    """(lineno, text, comment_only) for every real COMMENT token.

    ``comment_only`` is True when nothing but whitespace precedes the
    comment on its line.  Tokenization errors (the caller has already
    ast-parsed the file, so these are near-impossible) degrade to the
    comments seen so far."""
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string,
                            tok.line[: tok.start[1]].strip() == ""))
    except (tokenize.TokenError, IndentationError):  # photon-lint: disable=swallowed-exception (degrade to the comments seen so far, documented above)
        pass
    return out


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def github(self) -> str:
        return (f"::error file={self.path},line={self.line},"
                f"title={self.rule}::{self.message}")


# ---------------------------------------------------------------------------
# Shared AST plumbing
# ---------------------------------------------------------------------------


def _parents(tree: ast.AST) -> dict:
    par: dict = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


def _ancestors(node: ast.AST, par: dict):
    n = par.get(node)
    while n is not None:
        yield n
        n = par.get(n)


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute/name chain as a string, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None



class _FileContext:
    """One parsed source file + its waiver table."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.parents = _parents(self.tree)
        self.waivers: dict[int, set[str]] = {}
        self.bad_waivers: list[int] = []
        lines = source.splitlines()
        # Real COMMENT tokens only (tokenize): a waiver example quoted
        # inside a docstring/string literal must neither suppress the
        # next code line nor be reported as a bad waiver.
        for lineno, text, comment_only in _comments(source):
            m = _WAIVER_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = (m.group(2) or "").strip()
            if not reason:
                self.bad_waivers.append(lineno)
                continue
            self.waivers.setdefault(lineno, set()).update(rules)
            # A waiver on a comment-only line covers the next code
            # line (the inline form rarely fits the line limit).
            if comment_only:
                nxt = lineno + 1
                while nxt <= len(lines) and (
                        not lines[nxt - 1].strip()
                        or lines[nxt - 1].strip().startswith("#")):
                    nxt += 1
                if nxt <= len(lines):
                    self.waivers.setdefault(nxt, set()).update(rules)

    def waived(self, line: int, rule: str) -> bool:
        return rule in self.waivers.get(line, ())


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Rule: unlocked-shared-write
# ---------------------------------------------------------------------------

_MUTATORS = ("append", "extend", "insert", "add", "update", "clear",
             "pop", "popitem", "remove", "discard", "setdefault",
             "move_to_end", "sort")
_LOCK_CTORS = ("threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition")
_SYNC_CTORS = _LOCK_CTORS + ("queue.Queue", "Queue", "threading.Event",
                             "Event", "queue.LifoQueue",
                             "queue.PriorityQueue")
_THREAD_CTORS = ("threading.Thread", "Thread")
_POOL_CTORS = ("ThreadPoolExecutor",
               "concurrent.futures.ThreadPoolExecutor")


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _MethodInfo:
    def __init__(self, node):
        self.node = node
        self.write_nodes: list[tuple[str, ast.AST]] = []  # attr, ast node
        # (attr, line, locked, kind) — kind "rmw" | "rebind"
        self.writes: list[tuple[str, int, bool, str]] = []
        self.reads: set[str] = set()
        self.calls: set[str] = set()    # self.X() method calls


def _scan_class(cls: ast.ClassDef, par: dict):
    methods: dict[str, _MethodInfo] = {}
    workers: set[str] = set()
    lock_attrs: set[str] = set()
    sync_attrs: set[str] = set()

    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        mi = _MethodInfo(item)
        methods[item.name] = mi
        for node in ast.walk(item):
            if isinstance(node, ast.Call):
                tgt = _dotted(node.func)
                if tgt in _THREAD_CTORS:
                    for kw in node.keywords:
                        if kw.arg == "target":
                            attr = _self_attr(kw.value)
                            if attr:
                                workers.add(attr)
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "submit" and node.args):
                    attr = _self_attr(node.args[0])
                    if attr:
                        workers.add(attr)
                if isinstance(node.func, ast.Attribute):
                    if _self_attr(node.func) is not None:
                        # self.method(...)
                        mi.calls.add(node.func.attr)
                    else:
                        m_attr = _self_attr(node.func.value)
                        if m_attr is not None and \
                                node.func.attr in _MUTATORS:
                            # self.attr.append(...) etc.
                            mi.write_nodes.append((m_attr, node))
                if item.name == "__init__" and tgt in _SYNC_CTORS:
                    assign = par.get(node)
                    if isinstance(assign, ast.Assign):
                        for t in assign.targets:
                            attr = _self_attr(t)
                            if attr:
                                sync_attrs.add(attr)
                                if tgt in _LOCK_CTORS:
                                    lock_attrs.add(attr)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    elts = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t])
                    for e in elts:
                        attr = _self_attr(e)
                        if attr:
                            mi.write_nodes.append((attr, node))
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load):
                attr = _self_attr(node)
                if attr:
                    mi.reads.add(attr)
    # Lock coverage is resolved after the whole class is scanned, so a
    # lock attribute declared below its first use still counts.  Kind
    # "rmw" = read-modify-write (AugAssign / container mutator) — the
    # lost-update shape; "rebind" = plain assignment.
    for mi in methods.values():
        mi.writes = [(attr, node.lineno,
                      _under_lock(node, par, lock_attrs),
                      "rebind" if isinstance(node, ast.Assign) else "rmw")
                     for attr, node in mi.write_nodes]
    return methods, workers, lock_attrs, sync_attrs


def _under_lock(node: ast.AST, par: dict, lock_attrs: set[str]) -> bool:
    for anc in _ancestors(node, par):
        if isinstance(anc, ast.With):
            for item in anc.items:
                attr = _self_attr(item.context_expr)
                if attr and (attr in lock_attrs
                             or "lock" in attr.lower()):
                    return True
    return False


def check_thread_discipline(ctx: _FileContext):
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods, workers, lock_attrs, sync_attrs = _scan_class(
            cls, ctx.parents)
        if not workers and not lock_attrs:
            continue

        # Worker-reachable closure over self.X() calls.
        reach = set(workers)
        frontier = list(workers)
        while frontier:
            m = frontier.pop()
            if m not in methods:
                continue
            for callee in methods[m].calls:
                if callee in methods and callee not in reach:
                    reach.add(callee)
                    frontier.append(callee)

        worker_writes: dict[str, list] = {}
        worker_reads: set[str] = set()
        caller_access: set[str] = set()
        caller_writes: dict[str, list] = {}
        for name, mi in methods.items():
            if name == "__init__":
                continue
            if name in reach:
                for a, ln, locked, _kind in mi.writes:
                    worker_writes.setdefault(a, []).append((ln, locked,
                                                            name))
                worker_reads |= mi.reads
            else:
                for a, ln, locked, _kind in mi.writes:
                    caller_writes.setdefault(a, []).append((ln, locked,
                                                            name))
                caller_access |= mi.reads
                caller_access |= {a for a, _, _, _ in mi.writes}

        flagged: set[tuple[int, str]] = set()

        def flag(attr, ln, method, side):
            if (ln, attr) in flagged:
                return None
            flagged.add((ln, attr))
            return Violation(
                ctx.path, ln, "unlocked-shared-write",
                f"'{cls.name}.{attr}' written in {method}() without "
                f"the lock but shared with the {side} thread; guard "
                "with the class lock or route through queue.Queue/"
                "Event")

        if workers:
            for attr, writes in worker_writes.items():
                if attr in sync_attrs or attr not in caller_access:
                    continue
                for ln, locked, m in writes:
                    if not locked:
                        v = flag(attr, ln, m, "caller")
                        if v:
                            yield v
            for attr, writes in caller_writes.items():
                if attr in sync_attrs:
                    continue
                if attr not in worker_reads and attr not in worker_writes:
                    continue
                for ln, locked, m in writes:
                    if not locked:
                        v = flag(attr, ln, m, "worker")
                        if v:
                            yield v
        if lock_attrs:
            # Lock-owning class: every non-init READ-MODIFY-WRITE
            # (+=, container mutators — the lost-update shape) must
            # hold the lock.  The ChunkStore discipline: `get`/`put`
            # run on the prefetch thread and the main thread alike, so
            # there is no single-threaded method to exempt.  Plain
            # rebinds (e.g. a thread handle) are only flagged when the
            # worker/caller sharing analysis above proves them shared.
            for name, mi in methods.items():
                if name == "__init__":
                    continue
                for attr, ln, locked, kind in mi.writes:
                    if attr in sync_attrs or locked or kind != "rmw":
                        continue
                    if (ln, attr) in flagged:
                        continue
                    flagged.add((ln, attr))
                    yield Violation(
                        ctx.path, ln, "unlocked-shared-write",
                        f"'{cls.name}.{attr}' mutated in {name}() "
                        f"outside the class lock ({sorted(lock_attrs)})"
                        "; lock-owning classes mutate shared state "
                        "under it")


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Rule: accumulator-dtype
# ---------------------------------------------------------------------------


def _mentions_f32_or_device(node: ast.AST) -> str | None:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            d = _dotted(n.func)
            if d and d.split(".")[0] == "torch":
                return f"{d} (device fold)"
            if (isinstance(n.func, ast.Attribute) and n.func.attr == "float"
                    and not n.args and not n.keywords):
                return ".float() cast"
        d = _dotted(n) if isinstance(n, (ast.Attribute, ast.Name)) else None
        if d and d.endswith("float32"):
            return "float32 cast"
        if isinstance(n, ast.Constant) and n.value == "float32":
            return "float32 cast"
    return None


def check_accumulator_dtype(ctx: _FileContext):
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        names = {m.name for m in cls.body
                 if isinstance(m, ast.FunctionDef)}
        if not {"update", "result"} <= names:
            continue
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef):
                continue
            for node in ast.walk(method):
                if isinstance(node, ast.AugAssign):
                    attr = _self_attr(node.target)
                    if attr is None:
                        continue
                    why = _mentions_f32_or_device(node.value)
                    if why:
                        yield Violation(
                            ctx.path, node.lineno, "accumulator-dtype",
                            f"accumulator '{cls.name}.{attr}' folds "
                            f"through {why}; streaming metrics "
                            "accumulate on host in float64")

# ---------------------------------------------------------------------------
# Rule: env-read
# ---------------------------------------------------------------------------

_ENV_SANCTIONED_FILES = ("config.py",)


def check_env_read(ctx: _FileContext):
    if os.path.basename(ctx.path) in _ENV_SANCTIONED_FILES:
        return
    for node in ast.walk(ctx.tree):
        bad = None
        if isinstance(node, ast.Attribute) and _dotted(node) in (
                "os.environ",):
            bad = "os.environ"
        elif isinstance(node, ast.Call) and _dotted(node.func) in (
                "os.getenv", "getenv"):
            bad = "os.getenv"
        elif (isinstance(node, ast.Name) and node.id == "environ"
              and isinstance(node.ctx, ast.Load)):
            bad = "environ"
        if bad:
            yield Violation(
                ctx.path, node.lineno, "env-read",
                f"raw {bad} read; route through "
                "photon_ml_torch.config.read_env (the sanctioned "
                "registry) so every env knob is discoverable")


# ---------------------------------------------------------------------------
# Rule: naked-clock
# ---------------------------------------------------------------------------

_WALL_CLOCKS = ("time.time",)


def _calls_wall_clock(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call)
               and _dotted(n.func) in _WALL_CLOCKS
               for n in ast.walk(node))


def check_naked_clock(ctx: _FileContext):
    """Durations must come from a monotonic clock.

    ``time.time()`` is the wall clock: it steps under NTP adjustment
    and suspend/resume, so ``time.time() - t0`` can go negative or jump
    by seconds — every phase timer, bench number, and telemetry span in
    the repo uses ``monotonic``/``perf_counter`` instead (telemetry makes
    timing a first-class output, so a wall-clock duration is a
    data-corruption bug, not just jitter).  Flags
    subtractions where either operand is a direct ``time.time()`` call
    or a name assigned from one; epoch TIMESTAMPS (no subtraction) stay
    legal, and deliberate wall-clock math can carry a waiver."""
    def _scope(node: ast.AST):
        """Nearest enclosing function (None = module scope) — plain
        names are tainted PER FUNCTION, so `t0 = time.time()` in one
        function cannot flag another function's perf_counter `t0`
        subtraction (reuse of conventional names is the norm)."""
        for anc in _ancestors(node, ctx.parents):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return anc
        return None

    clock_names: dict = {}         # scope id -> set of tainted names
    attr_names: set[str] = set()   # self.<attr> taint is class/file-wide
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            if _dotted(node.value.func) in _WALL_CLOCKS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        clock_names.setdefault(
                            id(_scope(node)), set()).add(t.id)
                    else:
                        attr = _self_attr(t)
                        if attr:
                            attr_names.add(attr)

    def tainted(side: ast.AST, scoped: set[str]) -> bool:
        if _calls_wall_clock(side):
            return True
        for n in ast.walk(side):
            if (isinstance(n, ast.Name) and n.id in scoped
                    and isinstance(n.ctx, ast.Load)):
                return True
            attr = _self_attr(n)
            if attr is not None and attr in attr_names:
                return True
        return False

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
            scoped = clock_names.get(id(_scope(node)), set())
            if tainted(node.left, scoped) or tainted(node.right, scoped):
                yield Violation(
                    ctx.path, node.lineno, "naked-clock",
                    "duration arithmetic on time.time(): the wall "
                    "clock steps under NTP/suspend; use "
                    "time.monotonic() or time.perf_counter()")


# ---------------------------------------------------------------------------
# Rule: metric-name
# ---------------------------------------------------------------------------

# Dotted lowercase identifier with at least two segments
# ("namespace.metric"): the report, the bench telemetry block, and the
# history extractor all address metrics by dotted path, so a flat or
# mixed-case name silently falls out of every dashboard slice.
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
_METRIC_FNS = ("count", "gauge", "observe")
# Receivers that identify the metrics registry at a call site: the
# module-level helpers, the conventional session handles, and the
# session's own methods.  Keyed narrowly so ``line.count(",")`` (str)
# or a container's ``.count`` can never false-positive.
_METRIC_RECEIVERS = ("telemetry", "t", "tel", "self", "self._t")


def check_metric_name(ctx: _FileContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _METRIC_FNS):
            continue
        recv = _dotted(func.value)
        if recv not in _METRIC_RECEIVERS:
            continue
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            continue            # dynamic names: the caller's contract
        if not _METRIC_NAME_RE.match(arg.value):
            yield Violation(
                ctx.path, node.lineno, "metric-name",
                f"metric name {arg.value!r} is not a dotted lowercase "
                "identifier (want namespace.metric, e.g. "
                "'solver.sweeps'); flat or mixed-case names fall out "
                "of the report/history metric paths")


# ---------------------------------------------------------------------------
# Rule: swallowed-exception
# ---------------------------------------------------------------------------

# A call through any of these shapes counts as REPORTING the failure:
#   * attribute calls whose method name is a logging/telemetry verb
#     (logger.warning, log.event, telemetry.thread_exception, ...);
#   * calls rooted at the logging/warnings modules (logging.warning,
#     warnings.warn).
_REPORTING_ATTRS = frozenset({
    "debug", "info", "warning", "warn", "error", "exception",
    "critical", "log", "event", "heartbeat", "thread_exception",
})
_REPORTING_ROOTS = ("logging", "warnings")


def _handler_reports(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in _REPORTING_ATTRS):
                return True
            d = _dotted(func)
            if d and d.split(".")[0] in _REPORTING_ROOTS:
                return True
    return False


def _handler_discards(handler: ast.ExceptHandler) -> bool:
    """True when the handler body does NOTHING with the failure:
    only ``pass``/``continue``/``break``, bare or constant ``return``,
    and constant expressions (docstrings).  A handler that computes a
    fallback, retries with new state, or mutates anything is HANDLING
    the error — different contract, not this rule's."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Return):
            if stmt.value is None or isinstance(stmt.value,
                                                ast.Constant):
                continue
            return False
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue
        return False
    return True


def check_swallowed_exception(ctx: _FileContext):
    """An ``except`` that silently discards the failure hides it: the
    run proceeds on wrong/partial state and the forensic trail has
    nothing (fault tolerance is only honest when every
    absorbed failure is reported, handled with a real fallback, or
    explicitly waived as best-effort).  The waiver's mandatory reason
    IS the documentation of why silence is correct at that site."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _handler_discards(node) or _handler_reports(node):
            continue
        what = (_dotted(node.type) if node.type is not None
                else "BaseException")
        yield Violation(
            ctx.path, node.lineno, "swallowed-exception",
            f"except {what or '...'} handler silently discards the "
            "failure: report it (logger/telemetry), handle it with a "
            "real fallback, or waive with a reason documenting why "
            "best-effort silence is correct here")


# ---------------------------------------------------------------------------
# Rule: eternal-wait
# ---------------------------------------------------------------------------

# Zero-argument blocking calls that wait forever without a timeout.
# The zero-arg requirement keeps dict.get(key) / str.join(seq) /
# path.join(a, b) out by construction: the flagged shapes are
# queue.Queue.get(), threading.Event.wait() / Condition.wait(), and
# Thread.join().
_ETERNAL_ZERO_ARG = ("get", "wait", "join")


def _has_timeout_kw(call: ast.Call) -> bool:
    return any(kw.arg in ("timeout", "timeout_s") and not (
        isinstance(kw.value, ast.Constant) and kw.value.value is None)
        for kw in call.keywords)


def check_eternal_wait(ctx: _FileContext):
    """A thread-spawning class owns at least one cross-thread wait; a
    wait with NO timeout turns a dead peer into a silently pinned
    thread (the wedged-replica outage class).  Flags
    ``.get()`` / ``.wait()`` / ``.join()`` calls with neither a
    positional argument nor a timeout keyword, and ``.recv(...)``
    (socket reads — the timeout lives in ``settimeout``, which static
    analysis cannot prove was called) inside classes that construct
    ``threading.Thread`` / ``ThreadPoolExecutor``.  Deliberately
    unbounded waits (a ``close()`` that provably enqueues a sentinel,
    a main thread parked on a stop event) carry a waiver naming the
    termination argument."""
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        spawns = any(
            isinstance(n, ast.Call)
            and _dotted(n.func) in _THREAD_CTORS + _POOL_CTORS
            for n in ast.walk(cls))
        if not spawns:
            continue
        for node in ast.walk(cls):
            if not isinstance(node, ast.Call) or not isinstance(
                    node.func, ast.Attribute):
                continue
            name = node.func.attr
            if name in _ETERNAL_ZERO_ARG:
                if node.args or _has_timeout_kw(node):
                    continue
                recv = _dotted(node.func.value) or "<expr>"
                yield Violation(
                    ctx.path, node.lineno, "eternal-wait",
                    f"{recv}.{name}() blocks with no timeout in "
                    f"thread-spawning class '{cls.name}': a dead peer "
                    "pins this thread forever — pass a timeout (poll) "
                    "or waive with the termination argument")
            elif name == "recv" and not _has_timeout_kw(node):
                recv = _dotted(node.func.value) or "<expr>"
                yield Violation(
                    ctx.path, node.lineno, "eternal-wait",
                    f"{recv}.recv() in thread-spawning class "
                    f"'{cls.name}': socket reads block forever unless "
                    "settimeout() was called — set one (or waive "
                    "naming where the timeout is applied)")


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Rule: collective-in-host-branch
# ---------------------------------------------------------------------------

# Collectives every participant must reach, or the others wait at the
# barrier forever: torch.distributed's, and the mesh's wrappers
# (parallel.mesh).  The fleet reducer's per-step ``reduce`` is matched
# by its receiver (``_reducer_names``).
_COLLECTIVE_FNS = ("all_reduce", "all_gather", "reduce_scatter",
                   "broadcast", "barrier", "all_reduce_sum",
                   "all_reduce_max")


def _reducer_names(tree: ast.AST) -> set[str]:
    """Names bound from a ``[fleet.]reducer()`` call anywhere in the
    file (conventionally ``fred = fleet.reducer()``)."""
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and (_dotted(node.value.func) or "").split(".")[-1]
                == "reducer"):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _collective_name(call: ast.Call, reducers: set[str]) -> str | None:
    d = _dotted(call.func)
    if d and d.split(".")[-1] in _COLLECTIVE_FNS:
        return d.split(".")[-1]
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == "reduce":
        recv = func.value
        if isinstance(recv, ast.Name) and recv.id in reducers:
            return "reduce"
        if (isinstance(recv, ast.Call)
                and (_dotted(recv.func) or "").split(".")[-1] == "reducer"):
            return "reduce"
    return None


def _divergent_host_test(test: ast.AST) -> bool:
    """Does a branch condition read the PROCESS IDENTITY — a value that
    differs per process, so the branch arms diverge across the fleet?
    ``get_rank()`` calls, ``process_index`` (a call or an attribute such
    as ``Mesh.process_index``) and ``host_id`` reads (the FleetContext
    field) qualify; ``get_world_size()`` does not — it is uniform."""
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            d = _dotted(n.func)
            if d and d.split(".")[-1] in ("get_rank", "process_index"):
                return True
        elif isinstance(n, ast.Attribute) and n.attr in ("host_id",
                                                         "process_index"):
            return True
        elif (isinstance(n, ast.Name) and n.id == "host_id"
              and isinstance(n.ctx, ast.Load)):
            return True
    return False


def check_collective_in_host_branch(ctx: _FileContext):
    """A collective lexically inside a branch conditioned on the process
    identity is a fleet deadlock: only SOME processes reach the
    barrier, the rest wait forever (the sharded streaming tier pads
    ragged shards with empty-chunk sentinels precisely so every host
    runs the same collective count).  Hoist the collective out of the
    branch, make the condition uniform across processes, or waive with
    the reason every process still participates."""
    reducers = _reducer_names(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _collective_name(node, reducers)
        if name is None:
            continue
        for anc in _ancestors(node, ctx.parents):
            # A def boundary ends the lexical branch: a helper merely
            # DEFINED under a host-conditional may be called by every
            # process (lambdas stay transparent).
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if (isinstance(anc, (ast.If, ast.While, ast.IfExp))
                    and _divergent_host_test(anc.test)):
                yield Violation(
                    ctx.path, node.lineno, "collective-in-host-branch",
                    f"{name} inside a branch on the process identity "
                    "(get_rank()/process_index/host_id, line "
                    f"{anc.lineno}): processes that skip the branch "
                    "never reach the collective and the fleet deadlocks "
                    "— hoist it out or make the condition uniform")
                break

# ---------------------------------------------------------------------------
# Rule: slow-unmarked (repo-level: needs the recorded durations)
# ---------------------------------------------------------------------------


def _is_slow_mark(node: ast.AST) -> bool:
    """Exactly ``[pytest.]mark.slow`` (optionally called) — a substring
    test would false-match e.g. a skipif reason mentioning "slow"."""
    if isinstance(node, ast.Call):
        node = node.func
    return (_dotted(node) or "").endswith("mark.slow")


def _test_has_slow(tree: ast.AST, func: str) -> bool:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "pytestmark":
                    v = node.value
                    marks = (v.elts if isinstance(v, (ast.List, ast.Tuple))
                             else [v])
                    if any(_is_slow_mark(m) for m in marks):
                        return True
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func:
            if any(_is_slow_mark(d) for d in node.decorator_list):
                return True
    return False


def check_slow_unmarked(root: str):
    dur_path = os.path.join(root, DURATIONS_FILE)
    if not os.path.exists(dur_path):
        return
    with open(dur_path) as f:
        recorded = json.load(f)
    durations = recorded.get("durations", recorded)
    by_func: dict[tuple[str, str], float] = {}
    for nodeid, secs in durations.items():
        if "::" not in nodeid:
            continue
        file_part, test_part = nodeid.split("::", 1)
        # Last :: segment = the function/method name (class-based tests
        # produce file.py::TestCls::test_x; ast.walk in _test_has_slow
        # visits methods, so the unqualified name is what matches).
        func = test_part.split("[", 1)[0].split("::")[-1]
        key = (file_part, func)
        by_func[key] = max(by_func.get(key, 0.0), float(secs))
    trees: dict[str, tuple] = {}
    for (file_part, func), secs in sorted(by_func.items()):
        if secs <= SLOW_THRESHOLD_S:
            continue
        path = os.path.join(root, file_part)
        if not os.path.exists(path):
            continue
        if path not in trees:
            with open(path) as f:
                src = f.read()
            ctx = _FileContext(path, src)   # parses once; .tree reused
            trees[path] = (ctx.tree, ctx)
        tree, ctx = trees[path]
        if _test_has_slow(tree, func):
            continue
        line = 1
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == func:
                line = node.lineno
                break
        v = Violation(
            path, line, "slow-unmarked",
            f"'{func}' measured {secs:.1f}s (> {SLOW_THRESHOLD_S:.0f}s "
            "threshold) in the recorded tier-1 run but lacks "
            "@pytest.mark.slow")
        if not ctx.waived(line, "slow-unmarked"):
            yield v


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

_FILE_CHECKERS = (
    check_thread_discipline,
    check_accumulator_dtype,
    check_env_read,
    check_naked_clock,
    check_metric_name,
    check_swallowed_exception,
    check_eternal_wait,
    check_collective_in_host_branch,
)


def check_source(source: str, path: str = "<fixture>",
                 rules=None) -> list[Violation]:
    """Run the per-file checkers over one source string (the unit-test
    surface for the fixture corpus)."""
    ctx = _FileContext(path, source)
    out: list[Violation] = []
    for checker in _FILE_CHECKERS:
        for v in checker(ctx):
            if rules is not None and v.rule not in rules:
                continue
            if not ctx.waived(v.line, v.rule):
                out.append(v)
    if rules is None or "bad-waiver" in rules:
        for line in ctx.bad_waivers:
            out.append(Violation(
                path, line, "bad-waiver",
                "photon-lint waiver without a (reason); every "
                "suppression must say why the contract does not apply"))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def _package_files(root: str) -> list[str]:
    pkg = os.path.join(root, PACKAGE)
    out = []
    for dirpath, _dirnames, filenames in os.walk(pkg):
        if "__pycache__" in dirpath:
            continue
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def run_checks(root: str, rules=None, files=None):
    """All violations for the repo at ``root`` (the ``photon_ml_torch``
    files + the recorded-duration test audit).  Returns (violations,
    files_checked)."""
    targets = files if files is not None else _package_files(root)
    violations: list[Violation] = []
    for path in targets:
        with open(path) as f:
            source = f.read()
        try:
            violations.extend(check_source(source, path, rules=rules))
        except SyntaxError as e:
            if rules is None or "syntax-error" in rules:
                violations.append(Violation(
                    path, e.lineno or 1, "syntax-error", str(e)))
    if rules is None or "slow-unmarked" in rules:
        audited = list(check_slow_unmarked(root))
        if files is not None:
            # Explicit file list: the audit still runs (the JSON must
            # not claim a requested rule ran when it did not), scoped
            # to those files.
            wanted = {os.path.abspath(p) for p in targets}
            audited = [v for v in audited
                       if os.path.abspath(v.path) in wanted]
        violations.extend(audited)
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations, len(targets)
