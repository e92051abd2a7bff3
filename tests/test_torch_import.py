"""The port imports no jax and nothing of the JAX package, importing its
kernel module needs no nvcc, and its entry points default to the card.

Each import check runs in a fresh interpreter: this test process has jax
and hvq_tpu loaded already (tests/conftest.py).
"""

import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

# Printed by a fresh interpreter: every loaded module of jax, of the JAX
# package (hvq_tpu, not hvq_tpu_torch) or of its TPU scripts (experiments).
_FOREIGN = (
    "print(sorted(m for m in sys.modules if m in ('jax', 'hvq_tpu', 'experiments')\n"
    "             or m.startswith(('jax.', 'hvq_tpu.', 'experiments.'))))\n"
)


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
        "from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries\n"
        "ds = generate_dataset(3000, seed=1, categories=20)\n"
        "qs = generate_queries(8, seed=2, categories=20)\n"
        "eng = hvq_tpu_torch.get_engine('batched')(ds, device='cpu', query_batch=8)\n"
        "ids, dists = eng.search(qs)\n"
        "assert ids.shape == (8, 100)\n"
        + _FOREIGN
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_partitioned_modules_and_cpu_search_leave_jax_unloaded():
    proc = _run(
        "import sys\n"
        "import hvq_tpu_torch.models.partitioned, hvq_tpu_torch.index.partition\n"
        "assert 'jax' not in sys.modules\n"
        "from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries\n"
        "from hvq_tpu_torch import get_engine\n"
        "ds = generate_dataset(3000, seed=1, categories=20)\n"
        "qs = generate_queries(8, seed=2, categories=20)\n"
        "eng = get_engine('partitioned')(ds, device='cpu', db_tile=512, query_batch=8)\n"
        "ids, dists = eng.search(qs)\n"
        "assert ids.shape == (8, 100)\n"
        + _FOREIGN
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_port_imports_nothing_of_the_jax_package():
    """The whole port in one interpreter: every module, a CPU search on
    both engines and the oracle, the CLI help and chip_smoke; afterwards no
    module of hvq_tpu (only hvq_tpu_torch) and none of jax is loaded."""
    proc = _run(
        "import pkgutil, runpy, sys\n"
        "import hvq_tpu_torch\n"
        "for m in pkgutil.walk_packages(hvq_tpu_torch.__path__, 'hvq_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        __import__(m.name)\n"
        "from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries\n"
        "ds = generate_dataset(3000, seed=1, categories=20)\n"
        "qs = generate_queries(8, seed=2, categories=20)\n"
        "for name, kw in (('batched', dict(query_batch=8)),\n"
        "                 ('partitioned', dict(db_tile=512, query_batch=8)),\n"
        "                 ('oracle', {})):\n"
        "    ids, _ = hvq_tpu_torch.get_engine(name)(ds, device='cpu', **kw).search(qs)\n"
        "    assert ids.shape == (8, 100)\n"
        "sys.argv = ['hvq_tpu_torch', 'run', '--help']\n"
        "try:\n"
        "    runpy.run_module('hvq_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "import chip_smoke\n"
        + _FOREIGN
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_port_sources_name_no_jax_no_jax_package_no_experiments():
    """No import statement of the port or of chip_smoke.py, at any depth
    (a function-level import the interpreter test would not reach too),
    names jax, hvq_tpu, experiments or the root bench.py."""
    foreign = re.compile(
        r"^\s*(from|import)\s+(jax|hvq_tpu|experiments|bench)(\.|\s|$)", re.M)
    files = sorted((REPO / "hvq_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not foreign.search(f.read_text()), f


def _tiny_ds():
    from hvq_tpu_torch.utils.generators import generate_dataset

    return generate_dataset(300, seed=1, categories=5)


def _view_arrays(n_pad=256):
    from types import SimpleNamespace

    z = np.zeros(n_pad, np.float32)
    return SimpleNamespace(Vp=np.zeros((n_pad, 128), np.float32), V_scan=None, C=z,
                           T=z, d_norms=z, oid=np.arange(n_pad, dtype=np.int32),
                           C_key=z, T_key=z, n=200, db_tile=128)


@pytest.mark.parametrize("name", ["BatchedEngine", "PartitionedEngine",
                                  "DeviceDB.from_dataset", "DeviceDB.from_arrays",
                                  "SortedView.from_arrays", "PartitionedIndex.build",
                                  "PartitionedIndex.from_arrays", "PagedEngine",
                                  "IVFEngine", "IVFIndex.build", "IVFIndex.from_host",
                                  "load_index"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch, tmp_path, name):
    """Every engine, view and index constructor and the checkpoint loader
    defaults to ``device="cuda"``; with the card hidden that default raises
    a clear error, never a CPU run."""
    from hvq_tpu_torch.index import serialize
    from hvq_tpu_torch.index.ivf import IVFIndex
    from hvq_tpu_torch.index.partition import PartitionedIndex, SortedView
    from hvq_tpu_torch.models.batched import BatchedEngine
    from hvq_tpu_torch.models.device_db import DeviceDB
    from hvq_tpu_torch.models.ivf import IVFEngine
    from hvq_tpu_torch.models.paged import PagedEngine
    from hvq_tpu_torch.models.partitioned import PartitionedEngine

    owner, _, attr = name.partition(".")
    fn = {"BatchedEngine": BatchedEngine, "PartitionedEngine": PartitionedEngine,
          "DeviceDB": DeviceDB, "SortedView": SortedView,
          "PartitionedIndex": PartitionedIndex, "PagedEngine": PagedEngine,
          "IVFEngine": IVFEngine, "IVFIndex": IVFIndex,
          "load_index": serialize.load_index}[owner]
    fn = getattr(fn, attr) if attr else fn
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    ds, view = _tiny_ds(), _view_arrays()
    ivf_arrays = dict(Vp=view.Vp, C=view.C, T=view.T, oid=view.oid, d_norms=view.d_norms,
                      centroids=np.zeros((2, 128), np.float32),
                      c_norms=np.zeros(2, np.float32), n=200, cap=128, scan_tile=128,
                      cat_vals=np.zeros(1, np.float32), cat_freq=np.ones(1),
                      t_sample=np.zeros(1, np.float32))
    ckpt = tmp_path / "ivf.npz"
    np.savez(ckpt, __kind__=np.array("ivf"), __version__=np.array(1),
             meta=np.array([200, 128, 128]),
             **{k: v for k, v in ivf_arrays.items() if isinstance(v, np.ndarray)})
    call = {
        "PagedEngine": lambda: PagedEngine(ds, db_tile=128, window_rows=128),
        "IVFEngine": lambda: IVFEngine(ds, cap=128),
        "IVFIndex.build": lambda: IVFIndex.build(ds, cap=128),
        "IVFIndex.from_host": lambda: IVFIndex.from_host(**ivf_arrays),
        "load_index": lambda: serialize.load_index(ckpt),
        "BatchedEngine": lambda: BatchedEngine(ds, query_batch=8),
        "PartitionedEngine": lambda: PartitionedEngine(ds, db_tile=128),
        "DeviceDB.from_dataset": lambda: DeviceDB.from_dataset(ds, db_tile=128),
        "DeviceDB.from_arrays": lambda: DeviceDB.from_arrays(
            view.Vp, view.C, view.T, view.d_norms, 200, 128),
        "SortedView.from_arrays": lambda: SortedView.from_arrays(view),
        "PartitionedIndex.build": lambda: PartitionedIndex.build(ds, db_tile=128),
        "PartitionedIndex.from_arrays": lambda: PartitionedIndex.from_arrays(
            view, np.zeros(200, np.float32)),
    }[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_kernel_module_imports_without_nvcc_and_build_says_why(tmp_path):
    proc = _run(
        "from hvq_tpu_torch.ops import kernels\n"
        "kernels.CUDA_ROOTS = ()\n"
        "assert kernels.launches == {'packed_scan_v3': 0, 'packed_scan': 0,\n"
        "                            'packed_scan_v2': 0, 'bin_scan': 0,\n"
        "                            'level2_select': 0}\n"
        "assert kernels.k1_body_launches == {'wgmma': 0, 'simt': 0}\n"
        "assert kernels.level2_body_launches == {'registers': 0, 'shared': 0}\n"
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
        + _FOREIGN
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-2:] == ["False", "[]"]


def test_chip_smoke_imports_no_jax_and_refuses_without_a_card():
    """Without a CUDA device chip_smoke raises before printing any result
    (the card is hidden here so the check holds on any machine)."""
    proc = _run(
        "import sys, torch\n"
        "import chip_smoke\n"
        "print('jax' in sys.modules)\n"
        + _FOREIGN +
        "torch.cuda.is_available = lambda: False\n"
        "chip_smoke.main()\n"
    )
    assert proc.returncode != 0
    assert proc.stdout.strip().splitlines() == ["False", "[]"]
    assert "no CUDA device" in proc.stderr


def test_k1_ablation_edits_find_their_anchors_in_the_source():
    """tools/k1_ablate builds its variants by anchored edits of K1's
    tensor-core body, the header both scan sources include: each anchor
    must occur exactly once, and each edit must change the text (importing
    the tool needs no card and no nvcc)."""
    from hvq_tpu_torch.ops import kernels
    from hvq_tpu_torch.tools import k1_ablate

    src = kernels._HEADERS[0].read_text()
    scans = [cu for cu in kernels._SOURCES
             if cu.name in ("packed_scan_v3.cu", "lane_scan.cu")]
    assert len(scans) == 2
    for cu in scans:
        assert f'#include "{kernels._HEADERS[0].name}"' in cu.read_text()
    assert k1_ablate.VARIANTS["base"] == ()
    for name, edits in k1_ablate.VARIANTS.items():
        text = src
        for anchor, edit in edits:
            assert text.count(anchor) == 1, name
            text = text.replace(anchor, edit)
        assert (text != src) == bool(edits), name
        assert text.count("{") == text.count("}"), name


def test_lane_shape_edits_find_their_anchor_in_lane_scan():
    """tools/k1_ablate builds each K3/K2 tensor-core shape by
    editing one line of csrc/lane_scan.cu: the shipped shape's line occurs
    there exactly once, and every other shape changes it."""
    from hvq_tpu_torch.ops import kernels
    from hvq_tpu_torch.tools import k1_ablate

    cu = next(p for p in kernels._SOURCES if p.name == "lane_scan.cu")
    src = cu.read_text()
    for name in k1_ablate.LANE_SHAPES:
        text = k1_ablate.edited(cu, k1_ablate.lane_shape_edit(name))
        assert (text != src) == (name != "base"), name


def _chip_smoke():
    """chip_smoke.py as a module (it needs no card to import)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_bounds_count_the_tpu_kernels_passes():
    """K2's bound counts its three bf16 passes, K3's and K4's the six of
    the fp32 emulation their TPU kernels ask for (HIGH maps to HIGHEST),
    at the D = 10⁶ lane shapes (n_pad = 123·8192, B = 1024; R = 4 for K3
    and K2, K4's own R = 2); K3 and K4 keep the IEEE fp32 CUDA-core figure
    beside it."""
    cs = _chip_smoke()
    n, B = 123 * 8192, 1024
    k2 = cs.lane_bound("packed_scan_v2", n, B, n * 4 // 128)
    k3 = cs.lane_bound("packed_scan", n, B, n * 4 // 128)
    k4 = cs.lane_bound("bin_scan", n, B, n * 2 // 128)
    assert round(k2["bound_ms"], 3) == 0.626 and "bound_fp32_simt_ms" not in k2
    for b in (k3, k4):
        assert round(b["bound_ms"], 3) == 1.252 and b["bound_by"] == "operations"
        assert round(b["bound_fp32_simt_ms"], 3) == 3.080


def test_chip_smoke_bounds_the_tpu_probe_scripts_from_their_shapes():
    """The three measurement scripts that reach pl.pallas_call outside the
    system's paths: the trivial copy and the int8 probe move more bytes
    than they compute on; K1's anatomy is the 3-pass (1-pass) product of
    B = 1024 over 61·16384 rows at all 128 lanes."""
    pb = _chip_smoke().probe_bounds()
    assert set(pb) == {"pallas_probe:32 _trivial", "int8_probe:83 bf16",
                       "int8_probe:83 int8", "v3_anatomy:189 fp32",
                       "v3_anatomy:189 bf16"}
    for name in ("pallas_probe:32 _trivial", "int8_probe:83 bf16", "int8_probe:83 int8"):
        assert pb[name]["bound_by"] == "bytes", name
    assert round(pb["v3_anatomy:189 fp32"]["bound_ms"], 3) == 0.795
    assert round(pb["v3_anatomy:189 bf16"]["bound_ms"], 3) == 0.265
    assert pb["int8_probe:83 int8"]["bound_ms"] < pb["int8_probe:83 bf16"]["bound_ms"]


def test_chip_smoke_certificate_ratio_nets_the_key_term_only_for_packed_keys():
    """Phase 3b's arithmetic on synthetic numbers: a packed key's error is
    net of its 2⁻¹⁶·true truncation; K4's unpacked score + ‖q‖² is not."""
    cs = _chip_smoke()
    true = torch.tensor([1000.0, 4.0], dtype=torch.float64)
    qn = torch.tensor([10.0, 30.0], dtype=torch.float64)
    dist = true + torch.tensor([0.02, -0.01], dtype=torch.float64)
    slack = 1e-4 * (qn + 50.0)                       # rel_mm·(‖q‖² + max‖d‖²)
    unpacked = cs.certificate_ratio(dist, true, qn, 50.0, 1e-4, packed=False)
    assert unpacked == pytest.approx(float(max(0.02 / slack[0], 0.01 / slack[1])))
    packed = cs.certificate_ratio(dist, true, qn, 50.0, 1e-4)
    want = max((0.02 - 2.0 ** -16 * 1000.0) / slack[0], (0.01 - 2.0 ** -16 * 4.0) / slack[1])
    assert packed == pytest.approx(float(want)) and packed < unpacked


# A synthetic level-2 select result of chip_smoke (level2_vs_plain's keys).
_LEVEL2 = dict(ms=0.4, plain_ms=15.0, bound_ms=0.287, bound_by="bytes", select_ms=0.6,
               plain_select_ms=15.5, B=1024, W=234624, rounds=8)


def _path(name):
    """A synthetic main-path result of chip_smoke (its run_engine keys)."""
    launches = {"packed_scan_v3": 0, "packed_scan": 0, "packed_scan_v2": 0, "bin_scan": 0,
                "level2_select": 10 if name == "packed_scan_v3" else 0}
    launches[name] = 10
    bodies = {"wgmma": 10 if name == "packed_scan_v3" else 0, "simt": 0}
    lanes = {k: {"wgmma": 0, "simt": 0} for k in ("packed_scan", "packed_scan_v2", "bin_scan")}
    if name in lanes:
        lanes[name]["wgmma"] = 10
    return dict(name=name, qps=1.0, ms=2.0, plain_ms=50.0, bound_ms=1.0,
                bound_by="operations", product_only_matmul_ms=1.5, launches=launches,
                bodies=bodies, lane_bodies=lanes, max_abs_err=0.01,
                bound_fp32_simt_ms=3.0,
                level2=_LEVEL2 if name == "packed_scan_v3" else None,
                by_predicate=_BY_PREDICATE if name == "packed_scan_v3" else None)


# A synthetic k1_by_predicate result of chip_smoke.
_BY_PREDICATE = dict(
    open=dict(ms=10.9, ms_rounds=[10.9, 11.0], open_warpgroups=19552, warpgroups=19552),
    predicated=dict(ms=15.2, ms_rounds=[15.2, 15.3], open_warpgroups=0, warpgroups=19552))


def test_chip_smoke_kernels_line_carries_k4s_new_keys():
    """On synthetic numbers: K4's entry carries its own path's bodies,
    certificate ratio, deterministic cases and product-only time beside
    the keys every kernel has; K3's keep theirs."""
    cs = _chip_smoke()
    r6 = {"v3": _path("packed_scan_v3"), "v1": _path("packed_scan"),
          "v2": _path("packed_scan_v2"),
          "k4": dict(ms=5.5, plain_ms=50.7, bound_ms=1.252, bound_by="operations",
                     bound_fp32_simt_ms=3.08, product_only_matmul_ms=5.6, launches=1,
                     bodies={"wgmma": 1, "simt": 0}, max_abs_err=0.002)}
    r7 = _path("packed_scan_v3")
    r8 = dict(_path("packed_scan_v3"), window=dict(ms=7.0, plain_ms=300.0, bound_ms=1.0,
                                                   bound_by="operations",
                                                   product_only_matmul_ms=4.0,
                                                   level2=dict(_LEVEL2, W=117120)))
    names = ("packed_scan_v3", "packed_scan", "packed_scan_v2", "bin_scan")
    worst = dict.fromkeys(names, 0.001)
    cert = {n: {"fp32": 0.01 * (i + 1)} for i, n in enumerate(names)}
    det = {n: 7 for n in names + ("level2_select",)}
    entries = {e["name"]: e for e in cs.kernel_entries(r6, r7, r8, worst, cert, det, "lib.so")}
    k4 = entries["bin_scan"]
    assert k4["bodies"] == {"wgmma": 1, "simt": 0} and k4["launches"] == 1
    assert k4["certificate_error_ratio"] == {"fp32": 0.04} and k4["deterministic_cases"] == 7
    assert k4["product_only_matmul_ms"] == 5.6 and k4["ms"] == 5.5 and k4["bound_ms"] == 1.252
    assert k4["max_abs_err"] == 0.002 and k4["library_ms"] is None
    assert entries["packed_scan"]["bodies"] == {"wgmma": 10, "simt": 0}
    l2 = entries["level2_select"]
    assert l2["launches"] == 30 and l2["bodies"] == {"registers": 30, "shared": 0}
    assert (l2["ms"], l2["plain_ms"], l2["bound_ms"], l2["bound_by"]) == (0.4, 15.0, 0.287,
                                                                       "bytes")
    assert l2["replaces"] is None and l2["library_ms"] is None
    assert l2["shapes"]["window_d1e7_bf16"]["W"] == 117120
    need = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(need <= set(e) for e in entries.values())


def test_chip_smoke_kernels_line_carries_k1_by_predicate():
    """On synthetic numbers: K1's entry carries its times with every query
    open and every query predicated at D=10⁶ fp32 and D=10⁷ bf16."""
    cs = _chip_smoke()
    r6 = {"v3": _path("packed_scan_v3"), "v1": _path("packed_scan"),
          "v2": _path("packed_scan_v2"),
          "k4": dict(ms=5.5, plain_ms=50.7, bound_ms=1.252, bound_by="operations",
                     product_only_matmul_ms=5.6, launches=1,
                     bodies={"wgmma": 1, "simt": 0}, max_abs_err=0.002)}
    r7 = dict(_path("packed_scan_v3"),
              by_predicate=dict(_BY_PREDICATE, open=dict(_BY_PREDICATE["open"], ms=10.5)))
    r8 = dict(_path("packed_scan_v3"), window=dict(ms=7.0, plain_ms=300.0, bound_ms=1.0,
                                                   bound_by="operations",
                                                   product_only_matmul_ms=4.0,
                                                   level2=dict(_LEVEL2, W=117120)))
    names = ("packed_scan_v3", "packed_scan", "packed_scan_v2", "bin_scan")
    entries = {e["name"]: e for e in cs.kernel_entries(
        r6, r7, r8, dict.fromkeys(names, 0.001), {n: {"fp32": 0.01} for n in names},
        {n: 7 for n in names + ("level2_select",)}, "lib.so")}
    k1 = entries["packed_scan_v3"]["by_predicate"]
    assert k1["d1e6_fp32"] == _BY_PREDICATE
    assert k1["d1e7_bf16"]["open"]["ms"] == 10.5
    assert k1["d1e7_bf16"]["predicated"] == _BY_PREDICATE["predicated"]


def test_chip_smoke_trivial_entry_carries_device_and_host_times():
    from hvq_tpu_torch.tools import int8_probe, v3_anatomy

    cs = _chip_smoke()
    timing = dict(ms=0.01, plain_ms=0.01, bound_ms=1e-4, bound_by="bytes")
    t_anat = {n: timing for n, *_ in v3_anatomy.ALL_SPECS}
    t_i8 = {v: dict(timing, product_only_ms=0.3) for v in int8_probe.VARIANTS}
    t_triv = dict(timing, library_ms=0.011, device_ms=0.002, host_us=7.5,
                  library_device_ms=0.0021, library_host_us=8.5,
                  launch_path_us={"trivial": 7.5, "x2": 8.5, "run_noop": 1.0,
                                  "launch_inputs": 15.0})
    keys = ([f"k1_anatomy {p} {s} R{R}" for _, s, R, p in v3_anatomy.ALL_SPECS]
            + [f"int8_probe {v}" for v in int8_probe.VARIANTS] + ["trivial"])
    counts, worst = dict.fromkeys(keys, 13), dict.fromkeys(keys, 0.0)
    entries = cs.probe_entries(t_anat, t_i8, t_triv, {"max_abs_err": 0.0}, counts, worst,
                               "probes.so")
    triv = entries[-1]
    assert triv["name"] == "trivial" and triv["launches"] == 13
    assert (triv["device_ms"], triv["host_us"]) == (0.002, 7.5)
    assert (triv["library_device_ms"], triv["library_host_us"]) == (0.0021, 8.5)
    assert triv["launch_path_us"]["run_noop"] == 1.0 and triv["library_ms"] == 0.011
    assert len(entries) == len(keys)


def test_lane_body_launches_count_bin_scan_and_reset_zeroes_them():
    from hvq_tpu_torch.ops import kernels

    assert set(kernels.lane_body_launches) == {"packed_scan", "packed_scan_v2", "bin_scan"}
    kernels.lane_body_launches["bin_scan"]["wgmma"] = 4
    kernels.lane_body_launches["bin_scan"]["simt"] = 1
    kernels.reset_launches()
    assert kernels.lane_body_launches["bin_scan"] == {"wgmma": 0, "simt": 0}


def test_paged_ivf_and_harness_modules_leave_jax_unloaded():
    """The paged and IVF engines searching on the CPU, a checkpoint round
    trip, the resilience and profiling helpers and every CLI subcommand's
    help, in one fresh interpreter: no module of jax or the JAX package."""
    proc = _run(
        "import runpy, sys, tempfile, os\n"
        "from hvq_tpu_torch import available_engines, get_engine\n"
        "from hvq_tpu_torch.index import serialize\n"
        "from hvq_tpu_torch.utils import profiling, resilience\n"
        "from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries\n"
        "assert available_engines() == ['batched', 'ivf', 'oracle', 'paged', 'partitioned',\n"
        "                               'partitioned_sharded', 'sharded']\n"
        "ds = generate_dataset(3000, seed=1, categories=20, clusters=8)\n"
        "qs = generate_queries(8, seed=2, categories=20)\n"
        "eng = get_engine('paged')(ds, device='cpu', db_tile=512, window_rows=1024,\n"
        "                          query_batch=8)\n"
        "ids, _ = resilience.ResilientEngine(eng).search(qs)\n"
        "assert ids.shape == (8, 100) and len(eng.windows) == 3\n"
        "ivf = get_engine('ivf')(ds, device='cpu', cap=128, kmeans_iters=2)\n"
        "assert ivf.search(qs)[0].shape == (8, 100)\n"
        "p = os.path.join(tempfile.mkdtemp(), 'ivf.npz')\n"
        "serialize.save_ivf(ivf.index, p)\n"
        "assert serialize.load_index(p, device='cpu').n == 3000\n"
        "for cmd in ('run', 'compare', 'build-index', 'gen-data', 'gen-queries'):\n"
        "    sys.argv = ['hvq_tpu_torch', cmd, '--help']\n"
        "    try:\n"
        "        runpy.run_module('hvq_tpu_torch.cli', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        + _FOREIGN
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_kernels_line_carries_the_paged_k1_launches():
    """On synthetic numbers: with phase 8's result, K1's entry counts the
    paged launches in its total and carries the paged window's shape, time
    and QPS; without it the entry is as before."""
    cs = _chip_smoke()
    r6 = {"v3": _path("packed_scan_v3"), "v1": _path("packed_scan"),
          "v2": _path("packed_scan_v2"),
          "k4": dict(ms=5.5, plain_ms=50.7, bound_ms=1.252, bound_by="operations",
                     bound_fp32_simt_ms=3.08, product_only_matmul_ms=5.6, launches=1,
                     bodies={"wgmma": 1, "simt": 0}, max_abs_err=0.002)}
    win = dict(ms=7.0, plain_ms=300.0, bound_ms=1.0, bound_by="operations",
               product_only_matmul_ms=4.0, level2=_LEVEL2)
    r8 = dict(_path("packed_scan_v3"), window=win)
    paged = dict(_path("packed_scan_v3"), window=dict(win, ms=9.5), qps=4321.0,
                 max_abs_err=0.02)
    paged["launches"]["packed_scan_v3"] = 50
    paged["bodies"] = {"wgmma": 50, "simt": 0}
    names = ("packed_scan_v3", "packed_scan", "packed_scan_v2", "bin_scan")
    args = (r6, _path("packed_scan_v3"), r8, dict.fromkeys(names, 0.001),
            dict.fromkeys(names, {}), dict.fromkeys(names + ("level2_select",), 7), "lib.so")
    k1 = cs.kernel_entries(*args, paged=paged)[0]
    before = cs.kernel_entries(*args)[0]
    assert k1["name"] == "packed_scan_v3" and before["launches"] == 30
    assert k1["launches"] == 80 and k1["launches_paged"] == 50
    assert k1["bodies"] == {"wgmma": 80, "simt": 0}
    assert k1["ms_paged_window_d1e7_fp32"] == 9.5 and k1["qps_paged_d1e7"] == 4321.0
    assert k1["shapes"]["paged_window_d1e7_fp32"]["ms"] == 9.5
    assert k1["max_abs_err"] == 0.02 and "launches_paged" not in before


def test_mesh_engines_search_on_cpu_shards_with_jax_unloaded():
    """Both mesh engines searching on an 8-CPU-shard mesh (and the 2×4
    q-by-d mesh for sharded) and the mesh dry run, in one fresh
    interpreter: no module of jax or the JAX package. The dry run's D=10⁶
    capacity leg is left out here (``HVQ_DRYRUN_CAPACITY=0``):
    tests/test_torch_capacity.py runs it at a CPU size."""
    proc = _run(
        "import sys\n"
        "from hvq_tpu_torch import get_engine\n"
        "from hvq_tpu_torch.entry import dryrun_multichip\n"
        "from hvq_tpu_torch.parallel.mesh import make_mesh\n"
        "from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries\n"
        "ds = generate_dataset(3000, seed=1, categories=20)\n"
        "qs = generate_queries(16, seed=2, categories=20)\n"
        "for name, mesh in (('sharded', make_mesh(devices=['cpu'] * 8)),\n"
        "                   ('sharded', make_mesh(4, 2, devices=['cpu'] * 8)),\n"
        "                   ('partitioned_sharded', make_mesh(devices=['cpu'] * 8))):\n"
        "    eng = get_engine(name)(ds, mesh=mesh, db_tile=128, query_batch=16)\n"
        "    ids, _ = eng.search(qs)\n"
        "    assert ids.shape == (16, 100)\n"
        "dryrun_multichip(8, device='cpu')\n"
        + _FOREIGN,
        HVQ_DRYRUN_CAPACITY="0",
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_kernels_line_carries_the_mesh_launches():
    """On synthetic numbers: with phases 9a–9c's results, K1's entry adds
    the sharded (4 virtual shards and 1), and partitioned_sharded launches
    to its total and carries the shard's shape and time; K3's adds the 2×2
    mesh's launches and its shard's shape; without them both are as
    before."""
    cs = _chip_smoke()
    r6 = {"v3": _path("packed_scan_v3"), "v1": _path("packed_scan"),
          "v2": _path("packed_scan_v2"),
          "k4": dict(ms=5.5, plain_ms=50.7, bound_ms=1.252, bound_by="operations",
                     bound_fp32_simt_ms=3.08, product_only_matmul_ms=5.6, launches=1,
                     bodies={"wgmma": 1, "simt": 0}, max_abs_err=0.002)}
    win = dict(ms=7.0, plain_ms=300.0, bound_ms=1.0, bound_by="operations",
               product_only_matmul_ms=4.0, level2=_LEVEL2)
    r8 = dict(_path("packed_scan_v3"), window=win)
    shard = dict(win, ms=8.5, max_abs_err=0.03)

    def mesh_path(name, n):
        p = _path(name)
        p["launches"][name] = n
        if name == "packed_scan_v3":
            p["bodies"] = {"wgmma": n, "simt": 0}
        else:
            p["lane_bodies"][name]["wgmma"] = n
        return p

    sharded = dict(mesh_path("packed_scan_v3", 40), shard=shard, qps=777.0,
                   max_abs_err=0.03, one_shard=dict(mesh_path("packed_scan_v3", 10), qps=888.0))
    k3 = dict(mesh_path("packed_scan", 44), shard=dict(win, ms=3.0, max_abs_err=0.04),
              qps=999.0, max_abs_err=0.04)
    mesh = dict(sharded=sharded, sharded_k3=k3,
                partitioned_sharded=mesh_path("packed_scan_v3", 84))
    names = ("packed_scan_v3", "packed_scan", "packed_scan_v2", "bin_scan")
    args = (r6, _path("packed_scan_v3"), r8, dict.fromkeys(names, 0.001),
            dict.fromkeys(names, {}), dict.fromkeys(names + ("level2_select",), 7), "lib.so")
    before = cs.kernel_entries(*args)
    k1, k3e = cs.kernel_entries(*args, mesh=mesh)[:2]
    assert before[0]["launches"] == 30 and before[1]["launches"] == 10
    assert k1["launches"] == 30 + 40 + 10 + 84 and k1["bodies"]["wgmma"] == 164
    assert (k1["launches_sharded"], k1["launches_sharded_1shard"],
            k1["launches_partitioned_sharded"]) == (40, 10, 84)
    assert k1["ms_shard_d1e7_fp32"] == 8.5 and k1["shapes"]["shard_d1e7_fp32"]["ms"] == 8.5
    assert k1["qps_sharded_1shard_d1e7"] == 888.0 and k1["max_abs_err"] == 0.03
    assert k3e["launches"] == 10 + 44 and k3e["launches_sharded_k3"] == 44
    assert k3e["bodies"]["wgmma"] == 54 and k3e["shapes"]["shard_d1e6_2x2"]["ms"] == 3.0
    assert k3e["max_abs_err"] == 0.04 and "launches_sharded" not in before[0]
    for e in (k1, k3e):
        for key in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms"):
            assert key in e, key
