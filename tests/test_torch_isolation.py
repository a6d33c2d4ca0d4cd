"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points take the card unless asked for the CPU."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.convert import resolve_device
from repro_torch.exec import compile_chain
from repro_torch.models import cnn

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    offenders = {str(f.relative_to(SRC)): m.group(0).strip()
                 for f in files
                 for m in [FORBIDDEN.search(f.read_text())] if m}
    assert not offenders, offenders


def test_forbidden_pattern_allows_the_port_itself():
    assert FORBIDDEN.search("from repro.core import gconv")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("import repro")
    assert not FORBIDDEN.search("from repro_torch.core import gconv")
    assert not FORBIDDEN.search("from ..core import gconv")


def test_port_imports_and_runs_with_jax_and_repro_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of them now fails
        sys.modules["repro"] = None
        import importlib, pkgutil
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.exec import compile_chain
        from repro_torch.models import cnn
        import torch
        chain = cnn.build("GLN", reduced=True, batch=2)
        eng = compile_chain(chain, device="cpu", backend="cuda")
        params = eng.init_params(torch.Generator().manual_seed(0))
        out = eng(cnn.random_inputs(chain, 1), params)
        assert out["softmax"].shape == (2, 10)
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print("isolated-ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated-ok" in out.stdout


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chain = cnn.build("GLN", reduced=True, batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile_chain(chain)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert compile_chain(chain, device="cpu").device == torch.device("cpu")


def test_resolve_device_rejects_other_devices():
    with pytest.raises(ValueError):
        resolve_device("meta")
