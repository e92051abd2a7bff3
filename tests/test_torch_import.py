"""The port imports no jax, and importing its kernel module needs no nvcc.

Each check runs in a fresh interpreter: this test process has jax loaded
already (tests/conftest.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(code: str, **env):
    full_env = {**os.environ, **env}
    full_env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=full_env,
        capture_output=True, text=True, timeout=300,
    )


def test_import_and_cpu_search_leave_jax_unloaded():
    proc = _run(
        "import sys\n"
        "import hvq_tpu_torch\n"
        "from hvq_tpu.utils.generators import generate_dataset, generate_queries\n"
        "ds = generate_dataset(3000, seed=1, categories=20)\n"
        "qs = generate_queries(8, seed=2, categories=20)\n"
        "eng = hvq_tpu_torch.get_engine('batched')(ds, device='cpu', query_batch=8)\n"
        "ids, dists = eng.search(qs)\n"
        "assert ids.shape == (8, 100)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_partitioned_modules_and_cpu_search_leave_jax_unloaded():
    proc = _run(
        "import sys\n"
        "import hvq_tpu_torch.models.partitioned, hvq_tpu_torch.index.partition\n"
        "assert 'jax' not in sys.modules\n"
        "from hvq_tpu.utils.generators import generate_dataset, generate_queries\n"
        "from hvq_tpu_torch import get_engine\n"
        "ds = generate_dataset(3000, seed=1, categories=20)\n"
        "qs = generate_queries(8, seed=2, categories=20)\n"
        "eng = get_engine('partitioned')(ds, device='cpu', db_tile=512, query_batch=8)\n"
        "ids, dists = eng.search(qs)\n"
        "assert ids.shape == (8, 100)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_kernel_module_imports_without_nvcc_and_build_says_why(tmp_path):
    proc = _run(
        "from hvq_tpu_torch.ops import kernels\n"
        "kernels.CUDA_ROOTS = ()\n"
        "assert kernels.launches == {'packed_scan_v3': 0, 'packed_scan': 0,\n"
        "                            'packed_scan_v2': 0, 'bin_scan': 0}\n"
        "try:\n"
        "    kernels.build()\n"
        "except RuntimeError as e:\n"
        "    print('raised', 'nvcc' in str(e))\n",
        PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised True"


def test_cli_help_imports_no_jax():
    proc = _run(
        "import runpy, sys\n"
        "sys.argv = ['hvq_tpu_torch', 'run', '--help']\n"
        "try:\n"
        "    runpy.run_module('hvq_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "print('jax' in sys.modules)\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "False"


def test_chip_smoke_imports_no_jax_and_refuses_without_a_card():
    """Without a CUDA device chip_smoke raises before printing any result
    (the card is hidden here so the check holds on any machine)."""
    proc = _run(
        "import sys, torch\n"
        "import chip_smoke\n"
        "print('jax' in sys.modules)\n"
        "torch.cuda.is_available = lambda: False\n"
        "chip_smoke.main()\n"
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == "False"
    assert "no CUDA device" in proc.stderr
