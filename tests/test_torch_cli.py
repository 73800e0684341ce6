"""emme_tpu_torch.cli on the CPU: the command line writes what driver.run
writes, passes its flags on, and refuses to run where there is no card
unless the CPU is asked for by name."""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from emme_tpu_torch import cli, driver

torch.set_num_threads(2)

DROP = ("run_time", "build_time")


def _input(tmp_path, cfg):
    path = tmp_path / "input.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_writes_driver_output_tok32(tmp_path, tokamak_cfg,
                                        golden_eigenvalues):
    """cli.main([... "--device", "cpu", "-q"]) on tokamak npoints 32 writes
    the output.json and the matrix dump of driver.run on the same input
    (but the run's times), with omega within 2e-6 of golden tok32."""
    cfg = dict(tokamak_cfg, npoints=32)
    rc = cli.main([_input(tmp_path, cfg), "-o", str(tmp_path / "cli"),
                   "--device", "cpu", "-q"])
    assert rc == 0
    driver.run(cfg, output_dir=tmp_path / "api", device="cpu", verbose=False)
    docs = [json.loads((tmp_path / d / "output.json").read_text())
            for d in ("cli", "api")]
    for doc in docs:
        for k in DROP:
            assert doc.pop(k)
    assert docs[0] == docs[1]
    om = complex(*docs[0]["result"]["(None)"]["scan_result"][0]["eigenvalue"])
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 2e-6
    dumps = [np.fromfile(tmp_path / d / "eigenMatrics" / "eigenMatrix.bin")
             for d in ("cli", "api")]
    assert np.array_equal(*dumps) and dumps[0].size == 2 * 32 * 32


def test_cli_passes_flags_on(tmp_path, monkeypatch):
    """Every flag reaches driver.run under its argument's name."""
    seen = {}
    monkeypatch.setattr(driver, "run", lambda path, **kw: seen.update(
        kw, path=path))
    cli.main(["job.json", "-o", "out", "--device", "cpu", "--f32",
              "--host64", "--no-checkpoint", "--chunk", "16384",
              "--scan-mode", "independent", "--scan-workers", "3",
              "--mesh-rows", "2", "--mesh-scan", "2", "--debug", "-q"])
    assert seen == dict(
        path="job.json", output_dir="out", dtype=torch.float32, device="cpu",
        checkpoint=False, verbose=False, chunk=16384, host64=True,
        scan_workers=3, scan_mode="independent", mesh_rows=2, mesh_scan=2,
        debug=True)
    seen.clear()
    cli.main(["--device", "cpu"])
    assert seen == dict(
        path="input.json", output_dir=".", dtype=torch.float64, device="cpu",
        checkpoint=True, verbose=True, chunk=2048, host64=False,
        scan_workers=1, scan_mode="wavefront", mesh_rows=None,
        mesh_scan=None, debug=False)


def test_cli_mesh_flags_show_the_drivers_error(tmp_path, tokamak_cfg):
    """--mesh-rows reaches the driver's mesh checks: scan workers without a
    scan axis, and a scan axis without rows, raise the driver's errors."""
    path = _input(tmp_path, dict(tokamak_cfg, npoints=32))
    with pytest.raises(ValueError, match="explicit scan axis"):
        cli.main([path, "-o", str(tmp_path), "--device", "cpu", "-q",
                  "--mesh-rows", "2", "--scan-workers", "2"])
    with pytest.raises(ValueError, match="needs mesh rows"):
        cli.main([path, "-o", str(tmp_path), "--device", "cpu", "-q",
                  "--mesh-scan", "2"])


@pytest.mark.parametrize("device", ["auto", "cuda"])
def test_cli_needs_a_card_unless_cpu_is_named(tmp_path, tokamak_cfg, device):
    """`python -m emme_tpu_torch.cli` with --device auto (the default) or
    cuda on a host without a card exits non-zero, names the missing card
    and writes nothing; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    path = _input(tmp_path, dict(tokamak_cfg, npoints=32))
    args = [] if device == "auto" else ["--device", device]
    out = subprocess.run(
        [sys.executable, "-m", "emme_tpu_torch.cli", path, "-o",
         str(tmp_path / "out"), "-q", *args],
        capture_output=True, text=True, timeout=120,
        cwd=str(pathlib.Path(driver.__file__).resolve().parents[1]))
    assert out.returncode != 0
    assert "CUDA card" in out.stderr and "--device cpu" in out.stderr
    assert not (tmp_path / "out").exists()
