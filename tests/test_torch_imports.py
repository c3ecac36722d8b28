"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports jax or the JAX package ``repro``."""
from __future__ import annotations

import re
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
