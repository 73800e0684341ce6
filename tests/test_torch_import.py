"""emme_tpu_torch stands alone: it imports torch and numpy, never jax."""
import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parent.parent / "emme_tpu_torch"

MODULES = [
    "emme_tpu_torch", "emme_tpu_torch.params", "emme_tpu_torch.geometry",
    "emme_tpu_torch.grid", "emme_tpu_torch.convert", "emme_tpu_torch._build",
    "emme_tpu_torch.ops", "emme_tpu_torch.solvers",
    "emme_tpu_torch.ops.singularity", "emme_tpu_torch.ops.quadrature",
    "emme_tpu_torch.ops.bessel", "emme_tpu_torch.ops.kernels",
    "emme_tpu_torch.ops.cuda_kappa", "emme_tpu_torch.ops.linalg",
    "emme_tpu_torch.solvers.eigen",
]


def test_modules_list_covers_package():
    found = {".".join(("emme_tpu_torch",) + p.relative_to(PKG).with_suffix("").parts)
             .removesuffix(".__init__") for p in PKG.rglob("*.py")}
    assert found == set(MODULES)


def test_import_leaves_jax_unloaded():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_statement():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert offenders == []
