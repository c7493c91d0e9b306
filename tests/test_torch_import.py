"""The PyTorch port imports with jax and flax unavailable (the card's
machine has neither), and no module of it imports jax."""
import os
import pkgutil
import subprocess
import sys

import audio8_tpu_torch

PKG_DIR = os.path.dirname(audio8_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="audio8_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "audio8_tpu_torch.cli.serve" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_imports_jax():
    offenders = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    for line in f:
                        s = line.strip()
                        if s.startswith(("import jax", "from jax",
                                         "import flax", "from flax")):
                            offenders.append(path)
    assert offenders == []


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result on a machine
    without CUDA (this one)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
