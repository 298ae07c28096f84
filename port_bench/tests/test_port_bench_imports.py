"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared by their
whole top-level part (adgs_tpu_torch begins with adgs_tpu)."""

import ast
import subprocess
import sys

from conftest import ROOT


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    from port_bench import guards, harness
    for path in harness.HERE.rglob("*.py"):
        tops = {guards.top(n) for n in _imports(path)}
        assert not tops & guards.FORBIDDEN, path


def test_reference_imports_only_plain_libraries():
    from port_bench import guards
    assert guards.reference_import_faults() == []


def test_guards_compare_whole_top_level_names():
    from port_bench import guards
    assert guards.top("adgs_tpu_torch.render") not in guards.FORBIDDEN
    assert guards.top("adgs_tpu.render") in guards.FORBIDDEN
    assert guards.top("jaxlib.xla_client") in guards.FORBIDDEN


def test_a_run_loads_no_jax():
    """In a fresh process: the harness, both drivers and the reference
    loaded with the program leave no jax, jaxlib, flax or adgs_tpu in
    sys.modules, and the reference holds nothing of the program."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.drivers.train, port_bench.drivers.render\n"
            "import port_bench.control, port_bench.bounds\n"
            "import adgs_tpu_torch.train.trainer, adgs_tpu_torch.render\n"
            "from port_bench import guards\n"
            "print(guards.forbidden_modules() + guards.reference_leaks())\n"
            % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
