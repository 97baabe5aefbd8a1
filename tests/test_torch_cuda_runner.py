"""Run the port's ``cuda``-marked tests on a GPU machine that has no JAX.

    python3 tests/test_torch_cuda_runner.py     # from the repository root

The test files import JAX and qst_tpu at module level for their CPU parity
cases; the ``cuda`` cases use neither. Run as a script, this module makes
every ``jax``, ``flax`` and ``qst_tpu`` import resolve to a stub, skips
``tests/conftest.py`` (which imports JAX), collects only ``-m cuda`` and
exits with pytest's code. Under pytest, the test below checks that the
runner collects those tests (they skip without a GPU).
"""

import importlib.abc
import importlib.machinery
import os
import subprocess
import sys
from unittest import mock

_STUBBED = ("jax", "jaxlib", "flax", "optax", "qst_tpu")
FILES = ("tests/test_torch_fused_layer.py", "tests/test_torch_topk.py",
         "tests/test_torch_fused_layer_bwd.py", "tests/test_torch_quadruplet.py",
         "tests/test_torch_losses.py", "tests/test_torch_train.py", "tests/test_torch_data.py",
         "tests/test_torch_ivf.py", "tests/test_torch_mpnet.py")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stub(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports any module under ``_STUBBED`` as a MagicMock package."""

    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in _STUBBED:
            return importlib.machinery.ModuleSpec(name, self, is_package=True)
        return None

    def create_module(self, spec):
        module = mock.MagicMock(name=spec.name)
        module.__path__ = []
        module.__spec__ = spec
        return module

    def exec_module(self, module):
        pass


def main() -> int:
    import pytest

    sys.meta_path.insert(0, _Stub())
    sys.path.insert(0, _ROOT)
    return pytest.main(["-q", "-p", "no:cacheprovider", "--noconftest", "-m", "cuda",
                        *(os.path.join(_ROOT, f) for f in FILES)])


def test_runner_collects_the_cuda_tests():
    run = subprocess.run([sys.executable, os.path.abspath(__file__)], cwd=_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    last = run.stdout.strip().splitlines()[-1]
    assert "deselected" in last and ("skipped" in last or "passed" in last), last
    assert "error" not in last and "failed" not in last, last


if __name__ == "__main__":
    sys.exit(main())
