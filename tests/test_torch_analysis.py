"""photon-lint over the port (``photon_ml_torch.analysis``).

- Parity: every fixture snippet of ``tests/test_analysis.py`` (read by
  AST, so a fixture added there is held here too) goes through both
  packages' ``check_source`` restricted to the rules they share, and
  the ``(line, rule)`` lists must be equal; the slow-test audit's
  fixture trees go through both ``check_slow_unmarked``; a file that
  does not parse through both ``run_checks``.
- The two retargeted rules in PyTorch idiom: ``accumulator-dtype``
  (a ``torch.*`` call or a float32 cast folded into an accumulator)
  and ``collective-in-host-branch`` (``torch.distributed``'s
  collectives, the mesh's wrappers and the fleet reducer's ``reduce``
  under ``get_rank()`` / ``process_index`` / ``host_id``).
- The tier-1 gate: the port's ``run_checks`` over ``photon_ml_torch/``
  and the reference's ``run_checks`` over the same files both find
  nothing; a mutation of a copy of a port file trips both.
- The CLI contract of ``python -m photon_ml_torch.analysis``.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from photon_ml_torch.analysis import checkers as port
from photon_ml_tpu.analysis import checkers as ref
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TESTS = os.path.join(REPO_ROOT, "tests", "test_analysis.py")

# The rules both packages implement the same way (the meta-rule
# syntax-error and the repo-level slow-unmarked are compared below).
SHARED = {"unlocked-shared-write", "env-read", "naked-clock",
          "metric-name", "swallowed-exception", "eternal-wait",
          "bad-waiver"}


def _src(snippet: str) -> str:
    return textwrap.dedent(snippet).lstrip("\n")


def _pairs(violations) -> list[tuple[int, str]]:
    return [(v.line, v.rule) for v in violations]


# -- the reference's fixtures, read by AST -----------------------------------

_REF_TREE = ast.parse(open(REF_TESTS).read(), filename=REF_TESTS)
_REF_CONSTS = {t.id: node.value.value for node in _REF_TREE.body
               if isinstance(node, ast.Assign)
               and isinstance(node.value, ast.Constant)
               and isinstance(node.value.value, str)
               for t in node.targets if isinstance(t, ast.Name)}


def _literal(node: ast.AST):
    if isinstance(node, ast.Name) and node.id in _REF_CONSTS:
        return _REF_CONSTS[node.id]
    return ast.literal_eval(node)


def _is_src_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "_src")


def _fixture_text(node: ast.AST) -> str | None:
    """The text of ``_src(X)`` or ``_src(X).replace(a, b[, n])``."""
    if _is_src_call(node):
        return _src(_literal(node.args[0]))
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "replace"
            and _is_src_call(node.func.value)):
        return _fixture_text(node.func.value).replace(
            *[_literal(a) for a in node.args])
    return None


def _ref_snippets() -> dict[str, tuple[str, str]]:
    """id → (source, path) for every ``_src`` snippet of the reference's
    test functions; ``path`` is the ``check_source`` call's own."""
    out = {}
    for fn in _REF_TREE.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        paths = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "check_source" and node.args):
                for kw in node.keywords:
                    if kw.arg == "path":
                        paths[id(node.args[0])] = _literal(kw.value)
        texts = [(t, paths.get(id(node), "<fixture>"))
                 for node in ast.walk(fn)
                 if (t := _fixture_text(node)) is not None]
        for i, (text, path) in enumerate(texts):
            out[f"{fn.name}#{i}"] = (text, path)
    return out


def _ref_slow_trees() -> dict[str, dict[str, str]]:
    """test name → {relative path: text} of the files each slow-audit
    test of the reference writes under ``tmp_path``."""
    out = {}
    for fn in _REF_TREE.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        files = {}
        # ``tfile = tests_dir / "x.py"`` ... ``tfile.write_text(...)``
        bound = {t.id: node.value for node in ast.walk(fn)
                 if isinstance(node, ast.Assign)
                 and isinstance(node.value, ast.BinOp)
                 for t in node.targets if isinstance(t, ast.Name)}
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "write_text"):
                continue
            target = node.func.value
            if isinstance(target, ast.Name):
                target = bound.get(target.id)
            if not isinstance(target, ast.BinOp):
                continue
            arg = node.args[0]
            if (isinstance(arg, ast.Call)
                    and (ref._dotted(arg.func) or "") == "json.dumps"):
                text = json.dumps(_literal(arg.args[0]))
            elif isinstance(arg, ast.BinOp):
                continue        # a CLI test's file, not an audit tree
            else:
                text = _fixture_text(arg) or _literal(arg)
            files[os.path.join("tests", _literal(target.right))] = text
        if any(p.endswith("tier1_durations.json") for p in files):
            out[fn.name] = files
    return out


SNIPPETS = _ref_snippets()
SLOW_TREES = _ref_slow_trees()


def test_reference_fixtures_are_all_read():
    """The AST reader finds the reference's corpus: a snippet for every
    shared rule's section and every slow-audit tree."""
    assert len(SNIPPETS) >= 50
    flagged = set()
    for text, path in SNIPPETS.values():
        flagged |= {v.rule for v in ref.check_source(text, path, SHARED)}
    assert flagged == SHARED
    assert len(SLOW_TREES) >= 5


@pytest.mark.parametrize("case", sorted(SNIPPETS))
def test_shared_rules_match_reference(case):
    text, path = SNIPPETS[case]
    assert _pairs(port.check_source(text, path, SHARED)) == _pairs(
        ref.check_source(text, path, SHARED))


@pytest.mark.parametrize("case", sorted(SLOW_TREES))
def test_slow_audit_matches_reference(case, tmp_path):
    for rel, text in SLOW_TREES[case].items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    root = str(tmp_path)

    def seen(mod):
        return [(os.path.basename(v.path), v.line, v.rule)
                for v in mod.check_slow_unmarked(root)]

    assert seen(port) == seen(ref)
    tests = sorted(str(tmp_path / rel) for rel in SLOW_TREES[case]
                   if rel.endswith(".py"))
    for f in tests:   # the audit scoped to an explicit file list
        got = [_pairs(m.run_checks(root, {"slow-unmarked"}, [f])[0])
               for m in (port, ref)]
        assert got[0] == got[1]


def test_syntax_error_matches_reference(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n    pass\n")
    got = [m.run_checks(str(tmp_path), None, [str(bad)]) for m in (port,
                                                                   ref)]
    assert _pairs(got[0][0]) == _pairs(got[1][0]) == [(1, "syntax-error")]
    assert got[0][1] == got[1][1] == 1


def test_waiver_syntax_matches_reference():
    """A reasonless waiver is a bad-waiver, a comment-only waiver covers
    the next code line, a waiver inside a string does nothing."""
    text = _src('''
        import os

        # photon-lint: disable=env-read (bootstrap read)

        a = os.environ.get("A")
        b = os.environ.get("B")  # photon-lint: disable=env-read
        DOC = "# photon-lint: disable=env-read (in a string)"
        c = os.environ.get("C")
    ''')
    vs = port.check_source(text)
    assert _pairs(vs) == [(6, "bad-waiver"), (6, "env-read"),
                          (8, "env-read")]
    assert _pairs(vs) == _pairs(ref.check_source(text, rules=SHARED))
    assert str(vs[0]).startswith("<fixture>:6 bad-waiver")
    assert vs[1].github().startswith(
        "::error file=<fixture>,line=6,title=env-read::")
    assert "photon_ml_torch.config.read_env" in vs[1].message


# -- accumulator-dtype in PyTorch idiom --------------------------------------

_ACC = """
    import numpy as np
    import torch

    class StreamingLoss:
        def __init__(self):
            self._num = 0.0
            self._den = 0.0

        def update(self, scores, weights):
            {body}

        def result(self):
            return self._num / self._den
"""


@pytest.mark.parametrize("body, why", [
    ("self._num += torch.sum(scores * weights)", "torch.sum"),
    ("self._num += float(torch.dot(scores, weights))", "torch.dot"),
    ("self._num += scores.float().sum().item()", ".float()"),
    ("self._num += np.sum(scores.numpy().astype(np.float32))",
     "float32"),
    ("self._num += float(scores.to(torch.float32).sum())", "float32"),
    ("self._num += np.sum(np.asarray(scores, 'float32'))", "float32"),
])
def test_accumulator_dtype_flags_torch_folds(body, why):
    vs = port.check_source(_src(_ACC.format(body=body)))
    assert _pairs(vs) == [(10, "accumulator-dtype")]
    assert why in vs[0].message


@pytest.mark.parametrize("source", [
    _ACC.format(body="w = np.asarray(weights, np.float64)\n"
                     "            s = scores.detach().cpu().numpy()"
                     ".astype(np.float64)\n"
                     "            self._num += float(np.sum(w * s))\n"
                     "            self._den += float(np.sum(w))"),
    # No result(): not an accumulator.
    """
    import torch

    class NotAnAccumulator:
        def update(self, x):
            self._x += torch.sum(x)
    """,
    # A torch call outside an augmented assignment into self.
    _ACC.format(body="s = torch.sum(scores).double().item()\n"
                     "            self._num += s"),
])
def test_accumulator_dtype_accepts_host_f64(source):
    assert port.check_source(_src(source)) == []


def test_accumulator_dtype_waiver():
    body = ("self._num += torch.sum(scores)  # photon-lint: disable="
            "accumulator-dtype (float64 tensor on the CPU: a host fold)")
    assert port.check_source(_src(_ACC.format(body=body))) == []
    body = "self._num += torch.sum(scores)  # photon-lint: disable=" \
           "accumulator-dtype"
    assert sorted(v.rule for v in port.check_source(
        _src(_ACC.format(body=body)))) == ["accumulator-dtype",
                                           "bad-waiver"]


# -- collective-in-host-branch in PyTorch idiom ------------------------------


def test_collective_in_host_branch_flags_rank_branches():
    vs = port.check_source(_src("""
        import torch.distributed as dist
        from photon_ml_torch.parallel import fleet
        from photon_ml_torch.parallel.mesh import all_reduce_max, all_reduce_sum

        def f(t, ctx, mesh, tree):
            if dist.get_rank() == 0:
                dist.all_reduce(t)
            while ctx.host_id > 0:
                t = all_reduce_sum([t])[0]
            u = all_reduce_max([t]) if mesh.process_index == 0 else t
            if torch.distributed.get_rank():
                torch.distributed.barrier()
                dist.broadcast(t, src=0)
            fred = fleet.reducer()
            if host_id == 1:
                tree = fred.reduce(tree)
                tree = fleet.reducer().reduce(tree)
            if mesh.process_index() > 0:
                dist.all_gather([t], t)
                dist.reduce_scatter(t, [t])
            return u
    """))
    assert _pairs(vs) == [(7, "collective-in-host-branch"),
                          (9, "collective-in-host-branch"),
                          (10, "collective-in-host-branch"),
                          (12, "collective-in-host-branch"),
                          (13, "collective-in-host-branch"),
                          (16, "collective-in-host-branch"),
                          (17, "collective-in-host-branch"),
                          (19, "collective-in-host-branch"),
                          (20, "collective-in-host-branch")]
    assert "all_reduce inside a branch" in vs[0].message
    assert "line 6" in vs[0].message


def test_collective_in_host_branch_clean_cases():
    vs = port.check_source(_src("""
        import functools
        import torch.distributed as dist
        from photon_ml_torch.parallel import fleet

        def uniform(t):
            # the world size is the same on every process
            if dist.get_world_size() > 1:
                dist.all_reduce(t)
            return t

        def hoisted(t, tree):
            dist.all_reduce(t)
            tree = fleet.reducer().reduce(tree)
            if dist.get_rank() == 0:
                print(t, tree)
            return t

        def defined_not_run(t):
            if dist.get_rank() == 0:
                def helper(y):
                    # a def boundary ends the lexical branch
                    dist.all_reduce(y)
                return helper
            return None

        def not_a_collective(ctx, xs):
            if ctx.host_id == 0:
                return functools.reduce(lambda a, b: a + b, xs)
            return None
    """))
    assert vs == []


def test_collective_in_host_branch_waiver():
    vs = port.check_source(_src("""
        import torch.distributed as dist

        def f(t):
            if dist.get_rank() == 0:
                dist.all_reduce(t)  # photon-lint: disable=collective-in-host-branch (single-process test harness, no peers to deadlock)
            return t
    """))
    assert vs == []


# -- the tier-1 gate ---------------------------------------------------------


def _port_files() -> list[str]:
    return port._package_files(REPO_ROOT)


def test_port_clean():
    """The port (and the recorded-duration audit) is lint-clean under
    its own checker.  A failure reads exactly like the CLI output: fix
    the violation or add a reasoned waiver."""
    violations, n_files = port.run_checks(REPO_ROOT)
    assert n_files > 100
    assert violations == [], "\n".join(str(v) for v in violations)


def test_port_clean_under_reference_checker():
    files = _port_files()
    assert len(files) > 100
    violations, n_files = ref.run_checks(REPO_ROOT, files=files)
    assert n_files == len(files)
    assert violations == [], "\n".join(str(v) for v in violations)


def test_mutation_trips_both_checkers(tmp_path):
    """A bare ``except: pass`` and a zero-arg ``queue.get()`` written
    into a thread-spawning class of a copy of a port file: both
    checkers flag both lines; the unmutated copy is clean."""
    src = open(os.path.join(REPO_ROOT, "photon_ml_torch", "serving",
                            "batcher.py")).read()
    clean = tmp_path / "clean.py"
    clean.write_text(src)
    anchor = "    def _run(self) -> None:\n"
    assert src.count(anchor) == 1
    mutant = src.replace(anchor, anchor + (
        "        try:\n"
        "            self._q.get()\n"
        "        except:\n"
        "            pass\n"))
    bad = tmp_path / "mutant.py"
    bad.write_text(mutant)
    line = mutant[:mutant.index(anchor)].count("\n") + 1
    want = [(line + 2, "eternal-wait"), (line + 3, "swallowed-exception")]
    for mod in (port, ref):
        assert mod.run_checks(str(tmp_path), files=[str(clean)])[0] == []
        vs, _ = mod.run_checks(str(tmp_path), files=[str(bad)])
        assert _pairs(vs) == want, mod.__name__


# -- CLI contract ------------------------------------------------------------

_CLI = [sys.executable, "-m", "photon_ml_torch.analysis"]

_BAD = """
    import os
    import queue
    import threading
    import time


    class Pipeline:
        def __init__(self):
            self._q = queue.Queue()
            self._thread = threading.Thread(target=self._run)
            self.state = 0

        def _run(self):
            self.state = self._q.get()

        def poll(self):
            return self.state


    FLAG = os.environ.get("SOME_UNSANCTIONED_FLAG")


    def wall_clock_duration(t0):
        return time.time() - t0


    def best_effort(path):
        try:
            os.remove(path)
        except OSError:
            pass
"""


def _run_cli(*args, cwd=REPO_ROOT):
    return subprocess.run([*_CLI, *args], capture_output=True, text=True,
                          cwd=cwd, timeout=300)


def test_cli_contract_clean_and_violating(tmp_path):
    proc = _run_cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tail = json.loads(proc.stdout.strip().splitlines()[-1])
    assert tail["ok"] is True and tail["violations"] == 0
    assert tail["files_checked"] >= 105
    assert set(tail["rules_run"]) == set(port.RULES)
    assert tail["by_rule"] == {}

    bad = tmp_path / "bad.py"
    bad.write_text(_src(_BAD))
    proc = _run_cli(str(bad))
    assert proc.returncode == 1
    lines = proc.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    assert tail["ok"] is False and tail["files_checked"] == 1
    assert tail["violations"] == len(lines) - 1 >= 5
    assert set(tail["by_rule"]) == {"unlocked-shared-write",
                                    "eternal-wait", "env-read",
                                    "naked-clock", "swallowed-exception"}
    assert all(ln.startswith(os.path.relpath(str(bad), REPO_ROOT) + ":")
               for ln in lines[:-1])


def test_cli_github_format_and_rule_filter(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(_src(_BAD) + "\nX = 1  # photon-lint: disable=env-read\n")
    proc = _run_cli("--format", "github", "--rules", "env-read", str(bad))
    assert proc.returncode == 1
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("::error file=")
    assert "title=env-read" in lines[0] and "file=/" not in lines[0]
    tail = json.loads(lines[-1])
    # The reasonless waiver is out of the filter, as are the others.
    assert tail["by_rule"] == {"env-read": 1}
    assert tail["rules_run"] == ["env-read"]


def test_cli_rejects_unknown_and_unported_rules():
    proc = _run_cli("--rules", "jit-in-function")
    assert proc.returncode == 2
    assert "jit-in-function is not ported" in proc.stderr
    assert "no jit executables" in proc.stderr
    proc = _run_cli("--rules", "no-such-rule")
    assert proc.returncode == 2 and "unknown rules" in proc.stderr
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "rules": sorted(port.RULES)}
    assert set(port.NOT_PORTED) == set(ref.RULES) - set(port.RULES)
