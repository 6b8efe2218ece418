"""The rules the suite keeps, checked on its sources (CPU only, seconds).

- One marker leaves tests out of the tier-1 run: ``slow``.  It is given in
  one place, ``conftest.py``'s ``SLOW`` at the root of the repo, and
  registered in ``pytest.ini``; no test file writes it.
- Each ``SLOW`` entry names a test that exists and that is also ``heavy``,
  so ``pytest.ini``'s default run (``-m "not heavy"``) leaves it out as well.
- ``slow`` marks only tests of the JAX package alone: a file under ``tests/``
  that imports ``gaussian_splatting_tpu`` and not ``gaussian_splatting_torch``.
- The time limit of ``conftest.py`` fails a test that runs past it, with the
  test's name and the stacks, and the run goes on to the next test.
"""

import ast
import configparser
import glob
import importlib.util
import os
import subprocess
import sys
import textwrap

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
ROOT_CONFTEST = os.path.join(REPO, "conftest.py")
SOURCES = sorted(glob.glob(os.path.join(TESTS, "*.py"))
                 + glob.glob(os.path.join(REPO, "benchmark", "tests", "*.py")))


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT_CONFTEST)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _slow_by_file():
    """``SLOW`` as {path of the file: [test names]}."""
    by_file = {}
    for nodeid in _root_conftest().SLOW:
        path, name = nodeid.split("::")
        by_file.setdefault(os.path.join(REPO, path), []).append(name)
    return by_file


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def _markers(node):
    """The names of ``pytest.mark.<name>`` used anywhere under an AST node."""
    return {n.attr for n in ast.walk(node)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Attribute)
            and n.value.attr == "mark"}


def _imported_packages(tree):
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_slow_is_marked_in_one_place():
    written = [os.path.relpath(p, REPO) for p in SOURCES if "slow" in _markers(_tree(p))]
    assert written == []
    ini = configparser.ConfigParser()
    ini.read(os.path.join(REPO, "pytest.ini"))
    assert "slow:" in ini["pytest"]["markers"]


def test_every_slow_test_exists_and_is_heavy():
    by_file = _slow_by_file()
    assert by_file, "no test is marked slow"
    for path, names in by_file.items():
        tree = _tree(path)
        module_heavy = any(
            isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "pytestmark"
                                                 for t in node.targets)
            and "heavy" in _markers(node.value)
            for node in tree.body)
        tests = {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef)}
        for name in names:
            assert name in tests, f"{path}::{name}"
            decorated = set().union(*(_markers(d) for d in tests[name].decorator_list))
            assert module_heavy or "heavy" in decorated, f"{path}::{name}"


def test_slow_marks_only_jax_only_files():
    for path in _slow_by_file():
        name = os.path.relpath(path, REPO)
        packages = _imported_packages(_tree(path))
        assert os.path.dirname(path) == TESTS and not name.startswith("tests/test_torch_"), name
        assert "gaussian_splatting_tpu" in packages, name
        assert "gaussian_splatting_torch" not in packages, name


def test_time_limit_fails_a_hung_test_and_the_run_goes_on(tmp_path):
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""\
        import importlib.util
        spec = importlib.util.spec_from_file_location("root_conftest", {ROOT_CONFTEST!r})
        root = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(root)
        root.LIMIT_S = 2.0
        pytest_runtest_setup = root.pytest_runtest_setup
        pytest_runtest_call = root.pytest_runtest_call
        pytest_runtest_teardown = root.pytest_runtest_teardown
    """))
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_hangs.py").write_text(textwrap.dedent("""\
        import time

        def test_sleeps_past_the_limit():
            time.sleep(60)

        def test_runs_after_it():
            assert True
    """))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("PYTEST_", "XLA_"))}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider", "-p", "no:xdist",
         "-p", "no:randomly", "tests/test_hangs.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "tests/test_hangs.py::test_sleeps_past_the_limit ran past its time limit of 2 s" in out, out
    assert "PASSED tests/test_hangs.py::test_runs_after_it" in out, out
    # the stack every thread was in when the limit fired
    assert "most recent call first" in out and 'test_hangs.py", line 4 in test_sleeps' in out, out
