"""The port stands alone: every ``repro_torch`` module and
``chip_smoke.py`` import with jax and the JAX package blocked, no port
file names the JAX package or jax, and ``chip_smoke.py`` refuses to run
(and prints no result) without a card or outside the repository."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_repro():
    mods = _port_modules()
    for m in ("repro_torch.core.backend", "repro_torch.core.brief",
              "repro_torch.core.frontend",
              "repro_torch.kernels.fast_detect",
              "repro_torch.kernels.gaussian_blur",
              "repro_torch.kernels.hamming_match",
              "repro_torch.kernels.match_fused",
              "repro_torch.kernels.sad_fused",
              "repro_torch.kernels.sad_rectify", "repro_torch.localization",
              "repro_torch.localization.geometry",
              "repro_torch.localization.metrics",
              "repro_torch.localization.pose",
              "repro_torch.distributed", "repro_torch.distributed.compression",
              "repro_torch.serving", "repro_torch.serving.faults",
              "repro_torch.serving.queue", "repro_torch.serving.service",
              "repro_torch.serving.supervisor",
              "repro_torch.serving.failover", "repro_torch.serving.snapshot",
              "repro_torch.checkpoint", "repro_torch.checkpoint.store",
              "repro_torch.launch", "repro_torch.launch.mesh"):
        assert m in mods, m
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(SMOKE)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_no_port_file_names_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b"
                     r"|import\s+repro\.|from\s+repro\.)", re.M)
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert len(files) > 15
    for path in files:
        text = path.read_text()
        assert not pat.search(text), path
        assert "import repro." not in text and "from repro " not in text


def test_chip_smoke_without_a_card_fails_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(SMOKE)], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, timeout=120, cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
