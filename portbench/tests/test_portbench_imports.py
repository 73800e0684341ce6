"""What the benchmark imports: nothing whose top-level module name (the
part before the first dot, compared whole) is JAX's or the JAX package's;
and the plain reference imports nothing of the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1]
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "emme_tpu"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def imported_top_names(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_top_names(path) & FORBIDDEN


def test_the_port_passes_the_whole_name_comparison():
    # emme_tpu_torch begins with emme_tpu's name, and is not it
    assert "emme_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "emme_tpu_torch" not in imported_top_names(path)


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_loading_every_module_loads_no_jax():
    mods = ["portbench.harness", "portbench.tracing", "portbench.calibrate",
            "portbench.reference.operator", "portbench.reference.pic",
            "portbench.roofline.k1", "portbench.roofline.k3",
            "portbench.roofline.n1"]
    code = ("import sys, pathlib\n"
            "from portbench import harness\n"
            + "".join(f"import {m}\n" for m in mods)
            + "for d in ('entries', 'layers'):\n"
            "    for p in sorted((harness.PKG / d).glob('*.py')):\n"
            "        harness.load_module(p, 'x_' + p.stem.replace('.', '_'))\n"
            "import emme_tpu_torch.driver\n"
            "print(' '.join(m.split('.')[0] for m in sys.modules))\n")
    assert not _loaded_after(code) & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.operator, portbench.reference.pic\n"
            "print(' '.join(m.split('.')[0] for m in sys.modules))\n")
    assert "emme_tpu_torch" not in _loaded_after(code)
