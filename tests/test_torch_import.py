"""The port imports neither JAX nor the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = ("import importlib, pkgutil, sys, gpmp2_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "gpmp2_tpu_torch.__path__, 'gpmp2_tpu_torch.')]; "
            "assert 'gpmp2_tpu_torch.ops.sdf_lookup' in sys.modules; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'gpmp2_tpu' or m.startswith('gpmp2_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
