"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports jax or the JAX package ``repro``, and importing
a module of the port loads neither."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_pattern_catches_what_it_must():
    bad = ["import jax", "from jax import numpy", "import jax.numpy as jnp",
           "import repro", "from repro.core import bsm", "import repro.core",
           "    from repro import tuner"]
    good = ["import repro_torch", "from repro_torch.core import bsm",
            "import jaxlib_free", "# see repro/core/bsm.py"]
    for line in bad:
        assert FORBIDDEN.search(line), line
    for line in good:
        assert not FORBIDDEN.search(line), line


MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in (ROOT / "src" / "repro_torch").rglob("*.py")
    if p.name != "__init__.py")


_LOADED_BY = """\
import importlib, json, sys
seen, out = set(), {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    bad = sorted(m for m in sys.modules if m not in seen and (
        m == "jax" or m.startswith("jax.") or m == "repro"
        or m.startswith("repro.")))
    seen.update(bad)
    out[name] = bad
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def loaded_by():
    """One fresh interpreter imports every module in turn and records, for
    each, the jax / JAX-package modules that first appeared with it."""
    proc = subprocess.run([sys.executable, "-c", _LOADED_BY, *MODULES],
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", [
    "repro_torch.core.tensor", "repro_torch.parallel.ctx",
    "repro_torch.models.moe"])
def test_slice7_modules_stand_alone(module, loaded_by):
    """The blocked-tensor, sharding-context and MoE modules are in the
    port's module list, import neither jax nor ``repro`` and load
    neither."""
    assert module in MODULES
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert not FORBIDDEN.findall(path.read_text())
    assert loaded_by[module] == []


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax(module, loaded_by):
    """Importing the module puts neither jax nor the JAX package into
    ``sys.modules``."""
    assert loaded_by[module] == [], f"{module} loaded {loaded_by[module]}"


@pytest.mark.parametrize("module", [
    "repro_torch.models.mamba", "repro_torch.models.rwkv6",
    "repro_torch.configs.jamba_v0_1_52b", "repro_torch.configs.rwkv6_7b"])
def test_slice8_modules_stand_alone(module, loaded_by):
    """The recurrent mixers and their archs' configs are in the port's
    module list, import neither jax nor ``repro`` and load neither."""
    assert module in MODULES
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert not FORBIDDEN.findall(path.read_text())
    assert loaded_by[module] == []


@pytest.mark.parametrize("module", [
    "repro_torch.optim.adamw", "repro_torch.optim.schedules",
    "repro_torch.optim.compress", "repro_torch.optim.tree",
    "repro_torch.data.pipeline", "repro_torch.checkpoint.store",
    "repro_torch.launch.steps", "repro_torch.launch.train"])
def test_slice10_modules_stand_alone(module, loaded_by):
    """The training stack's modules are in the port's module list, import
    neither jax nor ``repro`` and load neither."""
    assert module in MODULES
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert not FORBIDDEN.findall(path.read_text())
    assert loaded_by[module] == []


@pytest.mark.parametrize("module", [
    "repro_torch.parallel.sharding", "repro_torch.parallel.collectives",
    "repro_torch.parallel.runtime", "repro_torch.parallel.matmul_2p5d",
    "repro_torch.parallel.pipeline", "repro_torch.parallel.ctx"])
def test_slice12_modules_stand_alone(module, loaded_by):
    """The sharding layer's modules are in the port's module list, import
    neither jax nor ``repro`` and load neither."""
    assert module in MODULES
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert not FORBIDDEN.findall(path.read_text())
    assert loaded_by[module] == []


@pytest.mark.parametrize("module", [
    "repro_torch.roofline", "repro_torch.roofline.hlo_cost",
    "repro_torch.launch.dryrun"])
def test_slice13_modules_stand_alone(module):
    """The dry run's modules import neither jax nor ``repro`` and load
    neither (the roofline package's ``__init__`` is a module of its own
    here, so it is imported in a fresh interpreter too)."""
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / "src" / module.replace(".", "/") / "__init__.py"
    assert not FORBIDDEN.findall(path.read_text())
    proc = subprocess.run([sys.executable, "-c", _LOADED_BY, module],
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])[module] == []
